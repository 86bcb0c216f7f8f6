"""Raw DEFLATE (RFC 1951) one-shot compression on the card (torch).

Counterpart of ``decompress_tpu/de.py: deflate`` for levels 0-12 and the
``rle``/``huffman_only``/``fixed`` strategies.  The pipeline is the
reference's, batch by batch in order: device LZ77 analysis of up to
``MAX_DEVICE_BATCH`` segments of ``SEGMENT_SIZE`` bytes, each with its
32 KiB history, with the cost-aware round B at levels 5-12
(``ops/lz77.py``, ``ops/cost_cu.py``); host block planning and Huffman tables
(the reference's own ``plan_blocks``); device slot build and bit pack
(``ops/pack_cu.py``, ``ops/bitpack.py``); host assembly.  The output is
byte-identical to the reference's.

``device`` names where the arrays live: ``"cuda"`` (the default) runs
the CUDA kernels, ``"cpu"`` their plain PyTorch versions.  A CUDA device
on a machine without one raises; nothing falls back.
"""

from __future__ import annotations

import numpy as np
import torch

from decompress_tpu.core import bitstream, huffman, tables
from decompress_tpu.de import (  # host-only helpers of the reference (no JAX)
    _HDR_PAD,
    MAX_DEVICE_BATCH,
    SEGMENT_SIZE,
    STRATEGY_LEVELS,
    _emit_stored,
    _np_u8,
    plan_blocks,
)

from .ops import bitpack, lz77, pack_cu


def _resolve_device(device) -> torch.device:
    """``device`` as a torch.device; CUDA must be present if asked for."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False; "
                "pass device='cpu' for the plain PyTorch path")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def deflate(data, level: int | None = None, *, segment_size: int | None = None,
            dynamic: bool | None = None, window_bits: int | None = None,
            dictionary: bytes | None = None, strategy: str | None = None,
            device="cuda") -> bytes:
    """One-shot DEFLATE compress (level 0 = stored), byte-identical to
    ``decompress_tpu.de.deflate`` with the same arguments.

    ``dynamic=False`` or ``strategy="fixed"`` forces fixed-Huffman
    blocks; ``window_bits`` (8..15) restricts match distances;
    ``dictionary`` seeds the match window; the default level is 6.
    Unknown levels raise ValueError.  The reference's ``config=`` object
    argument is not ported."""
    dev = _resolve_device(device)
    level = 6 if level is None else level
    dynamic = True if dynamic is None else dynamic
    window_bits = 15 if window_bits is None else window_bits
    if not 8 <= window_bits <= 15:
        raise ValueError("window_bits must be in 8..15")
    if strategy is not None:
        if strategy == "fixed":
            dynamic = False
        elif strategy in STRATEGY_LEVELS:
            level = STRATEGY_LEVELS[strategy] if level != 0 else 0
        else:
            raise ValueError(f"unknown strategy {strategy!r}")
    if level != 0:
        lz77.level_config(level)  # unknown levels raise here
    arr = _np_u8(data)
    n = arr.size
    w = bitstream.BitWriter()
    if n == 0:
        # empty fixed block: cheapest legal empty stream
        codes = huffman.canonical_codes(tables.FIXED_LIT_LENGTHS)
        w.write(1, 1)
        w.write(1, 2)
        w.write(int(codes[tables.EOB]), int(tables.FIXED_LIT_LENGTHS[tables.EOB]))
        return w.getvalue()
    if level == 0:
        _emit_stored(w, arr, final=True)
        return w.getvalue()

    seg = segment_size or SEGMENT_SIZE
    head = None
    if dictionary:
        d = _np_u8(dictionary)
        head = d[-min(d.size, tables.WINDOW_SIZE):]
    _deflate_batches(w, arr, level, seg, dev,
                     force_block=None if dynamic else "fixed",
                     window_bits=window_bits, dict_hist=head)
    return w.getvalue()


def _batch_rows(b: int) -> int:
    """Rows a batch of b segments is padded to (the reference's shapes)."""
    return MAX_DEVICE_BATCH if b == MAX_DEVICE_BATCH else 1 << (b - 1).bit_length()


def _history_len(start: int, dlen: int) -> int:
    return min(lz77.HIST, start + dlen)


def _fill_history(out: np.ndarray, arr, start: int, hl: int, dict_hist) -> None:
    """Write the hl history bytes before ``start`` into the tail of
    ``out`` (HIST bytes): preset-dictionary bytes, then input bytes."""
    from_arr = min(hl, start)
    from_dict = hl - from_arr
    if from_dict:
        out[lz77.HIST - hl: lz77.HIST - from_arr] = \
            dict_hist[dict_hist.size - from_dict:]
    if from_arr:
        out[lz77.HIST - from_arr:] = arr[start - from_arr: start]


def _build_batch(arr, seg_lo, seg_hi, seg, dict_hist=None):
    """Host-built batch for seg < HIST: every row carries its own
    history.  Returns (data uint8[b_pad, HIST + seg], n_valid, hist_len, b)."""
    n = arr.size
    b = seg_hi - seg_lo
    b_pad = _batch_rows(b)
    dlen = 0 if dict_hist is None else dict_hist.size
    data = np.zeros((b_pad, lz77.HIST + seg), dtype=np.uint8)
    n_valid = np.zeros(b_pad, dtype=np.int32)
    hist_len = np.zeros(b_pad, dtype=np.int32)
    for i, s in enumerate(range(seg_lo, seg_hi)):
        start = s * seg
        stop = min(start + seg, n)
        n_valid[i] = stop - start
        hist_len[i] = _history_len(start, dlen)
        _fill_history(data[i, :lz77.HIST], arr, start, int(hist_len[i]), dict_hist)
        data[i, lz77.HIST: lz77.HIST + (stop - start)] = arr[start:stop]
    return data, n_valid, hist_len, b


def _build_batch_payload(arr, seg_lo, seg_hi, seg, dict_hist=None):
    """Payload-only host buffers for :func:`_assemble_batch_device`
    (seg >= HIST, so one previous row covers the window).  Returns
    (payload uint8[b_pad, seg], head uint8[HIST], n_valid, hist_len, b)."""
    n = arr.size
    b = seg_hi - seg_lo
    b_pad = _batch_rows(b)
    dlen = 0 if dict_hist is None else dict_hist.size
    payload = np.zeros((b_pad, seg), dtype=np.uint8)
    n_valid = np.zeros(b_pad, dtype=np.int32)
    hist_len = np.zeros(b_pad, dtype=np.int32)
    for i, s in enumerate(range(seg_lo, seg_hi)):
        start = s * seg
        stop = min(start + seg, n)
        n_valid[i] = stop - start
        hist_len[i] = _history_len(start, dlen)
        payload[i, : stop - start] = arr[start:stop]
    start0 = seg_lo * seg
    head = np.zeros(lz77.HIST, dtype=np.uint8)
    _fill_history(head, arr, start0, _history_len(start0, dlen), dict_hist)
    return payload, head, n_valid, hist_len, b


def _assemble_batch_device(payload: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """Device-side batch assembly: row i's history is row i-1's payload
    tail, so only the first row's history crosses to the device."""
    hist = head.shape[0]
    hists = torch.cat([head[None], payload[:-1, payload.shape[1] - hist:]], 0)
    return torch.cat([hists, payload], 1)


def _deflate_batches(w, arr, level, seg, dev, force_block=None,
                     window_bits=15, dict_hist=None):
    """Analyze, repair, plan and pack every batch of segments, in order."""
    nseg = (arr.size + seg - 1) // seg
    for lo in range(0, nseg, MAX_DEVICE_BATCH):
        hi = min(lo + MAX_DEVICE_BATCH, nseg)
        if seg >= lz77.HIST:
            payload, head, n_valid, hist_len, b = _build_batch_payload(
                arr, lo, hi, seg, dict_hist)
            d_data = _assemble_batch_device(torch.from_numpy(payload).to(dev),
                                            torch.from_numpy(head).to(dev))
        else:
            data, n_valid, hist_len, b = _build_batch(arr, lo, hi, seg,
                                                      dict_hist)
            d_data = torch.from_numpy(data).to(dev)
        nv = torch.from_numpy(n_valid).to(dev)
        hl = torch.from_numpy(hist_len).to(dev)
        res = lz77.lz77_analyze(d_data, nv, hl, level=level, seg_len=seg,
                                window_bits=window_bits)
        res = lz77.analyze2_finish(res, d_data, nv, hl, level=level,
                                   seg_len=seg, window_bits=window_bits)
        _finish_batch(w, arr, lo, b, nseg, seg, n_valid, d_data, res,
                      force_block)


def _finish_batch(w, arr, seg_lo, b, nseg, seg, n_valid, d_data, res,
                  force_block=None):
    """Host half of one batch: block planning, device pack, assembly."""
    b_pad = d_data.shape[0]
    final_flags = np.array([(seg_lo + i) == nseg - 1 for i in range(b)],
                           dtype=bool)
    (hdr_vals, hdr_bits), tabs, kinds = plan_blocks(
        res["hist_lit"].cpu().numpy()[:b], res["hist_dist"].cpu().numpy()[:b],
        n_valid[:b], final_flags, pad_to=b_pad, force_block=force_block)
    # any packed (non-stored) block beat the stored cost, so < ~9 bits/byte
    out_words = (9 * seg) // 32 + 2 * _HDR_PAD
    words, totals = pack_segments(res, d_data[:, lz77.HIST:], hdr_vals,
                                  hdr_bits, *tabs, out_words=out_words)
    totals = totals.cpu().numpy()
    # fetch only the words used by non-stored segments
    used = [int(totals[i]) for i in range(b) if kinds[i] != "stored"]
    cap = (max(used) + 31) // 32 + 1 if used else 0
    words = words[:, :cap].cpu().numpy().astype("<u4")
    for i in range(b):
        final = (seg_lo + i) == nseg - 1
        if kinds[i] == "stored":
            start = (seg_lo + i) * seg
            _emit_stored(w, arr[start: start + int(n_valid[i])], final=final)
        else:
            w.write_packed(words[i].view(np.uint8), int(totals[i]))


def pack_segments(res, sym_lit, hdr_vals, hdr_bits, lit_codes, lit_bits,
                  dist_codes, dist_bits, eob_vals, eob_bits, *, out_words: int):
    """The pack of one batch: slot build, then the plane bit pack.

    ``res`` holds the parse arrays (on_path, is_match, length, dist) on
    the device of ``sym_lit`` (uint8[B, seg] payload bytes); the header
    and code tables are plan_blocks' numpy arrays.  Returns
    (words int64[B, out_words] of uint32 values, total_bits int64[B])."""
    dev = sym_lit.device

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    lit_cb = put((lit_codes.astype(np.int32) << 4) | lit_bits)
    dist_cb = put((dist_codes.astype(np.int32) << 4) | dist_bits)
    v01, n01, v23, n23 = pack_cu.build_slots(
        res["on_path"], res["is_match"], res["length"], res["dist"], sym_lit,
        lit_cb, dist_cb)
    words, total, _, _ = bitpack.pack_slot_planes(
        v01, n01, v23, n23, put(hdr_vals.astype(np.int64)), put(hdr_bits),
        put(eob_vals.astype(np.int64)), put(eob_bits), out_words)
    return words, total
