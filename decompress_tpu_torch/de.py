"""Raw DEFLATE (RFC 1951) one-shot compression on the card (torch).

Counterpart of ``decompress_tpu/de.py: deflate`` for levels 0-12 and the
``rle``/``huffman_only``/``fixed`` strategies.  The pipeline is the
reference's: device LZ77 analysis of up to ``MAX_DEVICE_BATCH`` segments
of ``SEGMENT_SIZE`` bytes, each with its 32 KiB history, with the
cost-aware round B at levels 5-12 (``ops/lz77.py``, ``ops/cost_cu.py``);
host block planning and Huffman tables (``plan_blocks``, copied from the
reference); device slot build and bit pack (``ops/pack_cu.py``,
``ops/bitpack.py``); host assembly.  Round A of the next
``PIPELINE_DEPTH`` batches is dispatched ahead of the host's work on the
current one (:func:`_deflate_pipelined`), with every host read ordered by
its own batch's event (``ops/transfer.py``).  The output is
byte-identical to the reference's.

``device`` names where the arrays live: ``"cuda"`` (the default) runs
the CUDA kernels, ``"cpu"`` their plain PyTorch versions.  A CUDA device
on a machine without one raises; nothing falls back.

The one-shot decode (:func:`inflate`, :func:`inflate_ex`,
:func:`inflate_into`) runs on the host, as the reference's does: the
native state machine of ``native/`` (a copy of the reference's), with
the table-driven :func:`_inflate_python` as its plain version.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from . import native
from .core import bitstream, huffman, tables
from .core.tables import (
    DIST_BASE,
    DIST_EXTRA,
    EOB,
    LENGTH_BASE,
    LENGTH_EXTRA,
    MAX_MATCH,
    MIN_MATCH,
    NUM_DIST_SYMS,
    NUM_LIT_SYMS,
    PRECODE_ORDER,
    WINDOW_SIZE,
)
from .ops import bitpack, graphs, lz77, pack_cu, transfer
from .utils import profiling

# ---------------------------------------------------------------------------
# Host half of the reference's de.py, copied (the port imports nothing of
# the reference package); tests/test_torch_core.py holds every constant and
# plan_blocks equal to the reference's.
# ---------------------------------------------------------------------------

#: payload bytes per device segment: just under 2^17, so the parse domain
#: pow2(seg + MAX_MATCH + 1) stays 2^17
SEGMENT_SIZE = (1 << 17) - 512
#: segments per device batch (the reference reads an environment override;
#: the port has none)
MAX_DEVICE_BATCH = 8
#: default output buffer of the streaming decoders (the reference's)
io_buffer_size = 65536
_HDR_PAD = 1024          # padded header slots per segment in the pack call
#: strategy name -> dedicated LEVELS slot ("fixed" is the dynamic=False knob)
STRATEGY_LEVELS = {"rle": 100, "huffman_only": 101}


class MalformedError(ValueError):
    """Typed data error; the messages are the reference's."""


# Command packing of the streaming queue (``streaming.Queue``): literal =
# byte, copy = ((len-3) << 16) | (off-1) | copy flag, EOB = 256.
_CMD_COPY_FLAG = 0x2000000
CMD_EOB = 256


def cmd_literal(byte: int) -> int:
    return byte & 0xFF


def cmd_copy(off: int, length: int) -> int:
    """Packed copy command: ((len-3) << 16) | (off-1) | copy flag."""
    if not (1 <= off <= WINDOW_SIZE):
        raise ValueError("invalid offset")
    if not (MIN_MATCH <= length <= MAX_MATCH):
        raise ValueError("invalid length")
    return ((length - MIN_MATCH) << 16) | (off - 1) | _CMD_COPY_FLAG


def cmd_is_copy(cmd: int) -> bool:
    return bool(cmd & _CMD_COPY_FLAG)


def cmd_unpack(cmd: int):
    """-> ('literal', byte) | ('copy', (off, len)) | ('end', None)."""
    if cmd & _CMD_COPY_FLAG:
        return "copy", ((cmd & 0xFFFF) + 1, ((cmd >> 16) & 0x1FF) + MIN_MATCH)
    if cmd == CMD_EOB:
        return "end", None
    return "literal", cmd & 0xFF


def _rle_code_lengths(lengths: np.ndarray):
    """RFC 1951 §3.2.7 code-length RLE: yields (sym, extra_val, extra_bits)."""
    out = []
    n = lengths.size
    i = 0
    while i < n:
        v = int(lengths[i])
        j = i + 1
        while j < n and int(lengths[j]) == v:
            j += 1
        run = j - i
        if v == 0:
            while run >= 11:
                r = min(run, 138)
                out.append((18, r - 11, 7))
                run -= r
            if run >= 3:
                out.append((17, run - 3, 3))
                run = 0
            for _ in range(run):
                out.append((0, 0, 0))
        else:
            out.append((v, 0, 0))
            run -= 1
            while run >= 3:
                r = min(run, 6)
                out.append((16, r - 3, 2))
                run -= r
            for _ in range(run):
                out.append((v, 0, 0))
        i = j
    return out


@dataclasses.dataclass
class DynamicHeader:
    values: np.ndarray  # uint32 pairs to emit (excluding BFINAL/BTYPE)
    nbits: np.ndarray
    bit_length: int


def build_dynamic_header(lit_lengths: np.ndarray, dist_lengths: np.ndarray) -> DynamicHeader:
    """Serialize HLIT/HDIST/HCLEN + precode + RLE'd code lengths."""
    hlit = max(257, int(np.max(np.nonzero(lit_lengths)[0])) + 1) if np.any(lit_lengths) else 257
    nz_d = np.nonzero(dist_lengths)[0]
    hdist = (int(nz_d[-1]) + 1) if nz_d.size else 1
    seq = np.concatenate([lit_lengths[:hlit], dist_lengths[:hdist]])
    rle = _rle_code_lengths(seq)

    pre_freq = np.zeros(19, dtype=np.int64)
    for sym, _, _ in rle:
        pre_freq[sym] += 1
    pre_lengths = huffman.code_lengths_from_frequencies(pre_freq, max_length=7)
    pre_codes = huffman.canonical_codes(pre_lengths)

    order = PRECODE_ORDER
    hclen = 19
    while hclen > 4 and pre_lengths[order[hclen - 1]] == 0:
        hclen -= 1

    values = [hlit - 257, hdist - 1, hclen - 4]
    nbits = [5, 5, 4]
    for k in range(hclen):
        values.append(int(pre_lengths[order[k]]))
        nbits.append(3)
    for sym, extra_val, extra_bits in rle:
        values.append(int(pre_codes[sym]))
        nbits.append(int(pre_lengths[sym]))
        if extra_bits:
            values.append(extra_val)
            nbits.append(extra_bits)
    values = np.array(values, dtype=np.uint32)
    nbits = np.array(nbits, dtype=np.int32)
    return DynamicHeader(values, nbits, int(nbits.sum()))


_FIXED_LIT_BITS = tables.FIXED_LIT_LENGTHS.astype(np.int64)
_FIXED_DIST_BITS = tables.FIXED_DIST_LENGTHS.astype(np.int64)[:30]
_LEN_EXTRA_OF_SYM = np.concatenate([np.zeros(257, np.int64), LENGTH_EXTRA.astype(np.int64)])
_DIST_EXTRA_OF_SYM = DIST_EXTRA.astype(np.int64)


def symbol_cost_bits(hist_lit: np.ndarray, hist_dist: np.ndarray,
                     lit_bits: np.ndarray, dist_bits: np.ndarray) -> int:
    """Exact bit cost of the symbol section (incl. extra bits, excl. header)."""
    lit = int(np.sum(hist_lit * (lit_bits[: hist_lit.size].astype(np.int64) + _LEN_EXTRA_OF_SYM[: hist_lit.size])))
    dst = int(np.sum(hist_dist * (dist_bits[: hist_dist.size].astype(np.int64) + _DIST_EXTRA_OF_SYM[: hist_dist.size])))
    return lit + dst


def stored_cost_bits(n: int, bitpos_in_byte: int) -> int:
    """Exact stored-block cost: each chunk is a 3-bit header, padding to
    the next byte boundary, a 32-bit LEN/NLEN word, then the raw bytes;
    chunks after the first start byte-aligned (5 bits of padding)."""
    nchunks = max(1, (n + 65534) // 65535)
    bits = 3 + ((-(bitpos_in_byte + 3)) % 8) + 32
    bits += (nchunks - 1) * (3 + 5 + 32)
    return bits + 8 * n


def _np_u8(data) -> np.ndarray:
    if isinstance(data, np.ndarray) and data.dtype == np.uint8:
        return data
    return np.frombuffer(bytes(data), dtype=np.uint8)


def _emit_stored(w: bitstream.BitWriter, payload: np.ndarray, final: bool) -> None:
    n = payload.size
    chunks = [(i, min(i + 65535, n)) for i in range(0, n, 65535)] or [(0, 0)]
    for ci, (lo, hi) in enumerate(chunks):
        last = final and ci == len(chunks) - 1
        w.write(1 if last else 0, 1)
        w.write(0, 2)
        w.align_to_byte()
        ln = hi - lo
        w.write(ln, 16)
        w.write(ln ^ 0xFFFF, 16)
        w.write_bytes(payload[lo:hi])


def compress_bound(n: int, segment_size: int | None = None) -> int:
    """Upper bound on :func:`deflate` output size for any level.

    The planner never emits a block bigger than its stored encoding, so
    the bound is the stored worst case (up to 6 bytes of header and
    alignment per stored chunk of min(segment, 65535) bytes) plus slack
    for the final empty block."""
    chunk = min(segment_size or SEGMENT_SIZE, 65535)
    return n + 6 * (n // chunk + 1) + 16


#: rows planned by :func:`plan_blocks`, by kind (``stored``, ``fixed``,
#: ``dynamic``), and ``overflow``: rows whose literal or distance tree
#: was redistributed to fit 15 bits.  Always on.
PLAN_COUNTS: collections.Counter = collections.Counter()
_KIND_NAMES = np.array(["stored", "fixed", "dynamic"])


@profiling.spanned("plan.blocks", cpu=True)
def plan_blocks(hist_lit, hist_dist, n_valid, final_flags, *, pad_to=None,
                force_block=None, shared_tree=False):
    """Host planning for a batch of blocks: choose stored/fixed/dynamic
    per block by exact cost, build the Huffman code tables and the
    serialized headers for the device packer.

    With ``shared_tree`` the dynamic trees are built once from the
    row-summed frequencies (or taken from a precomputed ``(lit_len,
    dist_len, header)`` tuple) and every dynamic block reuses them;
    per-block stored/fixed fallback still applies.

    One native call plans the batch (``native/plan.cpp``); its output is
    :func:`_plan_blocks_plain`'s byte for byte.

    Returns ((hdr_vals, hdr_bits), (lit_codes, lit_bits, dist_codes,
    dist_bits, eob_vals, eob_bits), kinds).
    """
    b_pad = pad_to or hist_lit.shape[0]
    # hdr_vals, hdr_bits, lit_codes, lit_bits, dist_codes, dist_bits,
    # eob_vals, eob_bits, zeroed: stored and padding rows stay so
    outs = tuple(np.zeros((b_pad, width), dtype=dt)
                 for width in (_HDR_PAD, NUM_LIT_SYMS, NUM_DIST_SYMS, 1)
                 for dt in (np.uint32, np.int32))
    kinds, overflow = native.plan_blocks(hist_lit, hist_dist, n_valid, final_flags,
                                         outs, force_block=force_block,
                                         shared_tree=shared_tree)
    n_stored, n_fixed, n_dynamic = np.bincount(kinds, minlength=3).tolist()
    PLAN_COUNTS.update(stored=n_stored, fixed=n_fixed, dynamic=n_dynamic,
                       overflow=overflow)
    return outs[:2], outs[2:], _KIND_NAMES[kinds].tolist()


def _plan_blocks_plain(hist_lit, hist_dist, n_valid, final_flags, *, pad_to=None,
                       force_block=None, shared_tree=False):
    """The plain model of :func:`plan_blocks`: the reference's planner, a
    Python loop over the rows.  The tests hold the native planner to it."""
    b = hist_lit.shape[0]
    b_pad = pad_to or b
    shared = None
    if shared_tree:
        if isinstance(shared_tree, tuple):
            shared = shared_tree  # precomputed (lit_len, dist_len, header)
        else:
            hl_sum = hist_lit.astype(np.int64).sum(axis=0)
            hl_sum[EOB] += b  # one EOB per block
            hd_sum = hist_dist.astype(np.int64).sum(axis=0)
            s_lit_len = huffman.code_lengths_from_frequencies(hl_sum)
            s_dist_len = huffman.code_lengths_from_frequencies(hd_sum)
            shared = (s_lit_len, s_dist_len,
                      build_dynamic_header(s_lit_len, s_dist_len))
    hdr_vals = np.zeros((b_pad, _HDR_PAD), dtype=np.uint32)
    hdr_bits = np.zeros((b_pad, _HDR_PAD), dtype=np.int32)
    lit_codes = np.zeros((b_pad, NUM_LIT_SYMS), dtype=np.uint32)
    lit_bits = np.zeros((b_pad, NUM_LIT_SYMS), dtype=np.int32)
    dist_codes = np.zeros((b_pad, NUM_DIST_SYMS), dtype=np.uint32)
    dist_bits = np.zeros((b_pad, NUM_DIST_SYMS), dtype=np.int32)
    eob_vals = np.zeros((b_pad, 1), dtype=np.uint32)
    eob_bits = np.zeros((b_pad, 1), dtype=np.int32)
    kinds = []
    for i in range(b):
        final = bool(final_flags[i])
        hl = hist_lit[i].astype(np.int64)
        hl[EOB] += 1
        hd = hist_dist[i].astype(np.int64)

        if shared is not None:
            dyn_lit_len, dyn_dist_len, header = shared
        else:
            dyn_lit_len = huffman.code_lengths_from_frequencies(hl)
            dyn_dist_len = huffman.code_lengths_from_frequencies(hd)
            header = build_dynamic_header(dyn_lit_len, dyn_dist_len)
        cost_dyn = 3 + header.bit_length + symbol_cost_bits(hl, hd, dyn_lit_len, dyn_dist_len)
        cost_fix = 3 + symbol_cost_bits(hl, hd, _FIXED_LIT_BITS, _FIXED_DIST_BITS)
        cost_sto = stored_cost_bits(int(n_valid[i]), 0)

        # forbidding dynamic trees does not forbid stored blocks (zlib's
        # Z_FIXED), or incompressible data would expand
        cost_packed = cost_fix if force_block == "fixed" else min(cost_dyn, cost_fix)
        if cost_sto < cost_packed:
            kinds.append("stored")
            continue
        if force_block == "fixed" or (force_block is None and cost_fix <= cost_dyn):
            kinds.append("fixed")
            ll, dl = tables.FIXED_LIT_LENGTHS, tables.FIXED_DIST_LENGTHS[:30]
            pairs = [(1 if final else 0, 1), (1, 2)]
        else:
            kinds.append("dynamic")
            ll, dl = dyn_lit_len, dyn_dist_len
            pairs = [(1 if final else 0, 1), (2, 2)]
        lc = huffman.canonical_codes(ll)
        dc = huffman.canonical_codes(dl)
        lit_codes[i, : lc.size] = lc[:NUM_LIT_SYMS]
        lit_bits[i, : lc.size] = ll[:NUM_LIT_SYMS]
        dist_codes[i] = dc[:NUM_DIST_SYMS]
        dist_bits[i] = dl[:NUM_DIST_SYMS]
        eob_vals[i, 0] = lc[EOB]
        eob_bits[i, 0] = ll[EOB]
        if kinds[-1] == "dynamic":
            pairs += list(zip(header.values.tolist(), header.nbits.tolist()))
        for j, (v, nb) in enumerate(pairs):
            hdr_vals[i, j] = v
            hdr_bits[i, j] = nb
    tabs = (lit_codes, lit_bits, dist_codes, dist_bits, eob_vals, eob_bits)
    return (hdr_vals, hdr_bits), tabs, kinds


def _parse_dynamic_lengths(r: bitstream.BitReader):
    """Parse a dynamic block header up to the code lengths; returns
    (lit_lengths, dist_lengths) with the reader positioned at the
    symbol section."""
    hlit = r.read(5) + 257
    hdist = r.read(5) + 1
    hclen = r.read(4) + 4
    if hlit > 286 or hdist > 30:
        raise MalformedError("invalid dictionary")
    pre = np.zeros(19, dtype=np.int32)
    for k in range(hclen):
        pre[int(PRECODE_ORDER[k])] = r.read(3)
    try:
        pre_dt = huffman.build_decode_table(pre, huffman.ROOT_BITS_CODES)
    except huffman.InvalidTree as e:
        raise MalformedError("invalid dictionary") from e
    lengths = np.zeros(hlit + hdist, dtype=np.int32)
    i = 0
    while i < hlit + hdist:
        sym, nb = huffman.decode_one(pre_dt, r.peek(15))
        if sym < 0:
            raise MalformedError("invalid dictionary")
        r.consume(nb)
        if sym < 16:
            lengths[i] = sym
            i += 1
        elif sym == 16:
            if i == 0:
                raise MalformedError("invalid dictionary")
            rep = 3 + r.read(2)
            lengths[i : i + rep] = lengths[i - 1]
            i += rep
        elif sym == 17:
            i += 3 + r.read(3)
        else:
            i += 11 + r.read(7)
    if i > hlit + hdist:
        raise MalformedError("invalid dictionary")
    if lengths[256] == 0:
        raise MalformedError("invalid dictionary")
    return lengths[:hlit], lengths[hlit:]


def _build_tables_from_header(r: bitstream.BitReader):
    lit_lens, dist_lens = _parse_dynamic_lengths(r)
    try:
        lit_dt = huffman.build_decode_table(lit_lens, huffman.ROOT_BITS_LENS)
        dist_dt = huffman.build_decode_table(
            dist_lens, huffman.ROOT_BITS_DISTS, allow_incomplete=True
        )
    except huffman.InvalidTree as e:
        raise MalformedError("invalid dictionary") from e
    return lit_dt, dist_dt


_FIXED_LIT_DT = None
_FIXED_DIST_DT = None
_FIXED_CODES = None


def _fixed_codes_cached():
    """Canonical (bit-reversed, emit-ready) fixed-tree codes."""
    global _FIXED_CODES
    if _FIXED_CODES is None:
        _FIXED_CODES = (
            huffman.canonical_codes(tables.FIXED_LIT_LENGTHS),
            huffman.canonical_codes(tables.FIXED_DIST_LENGTHS[:30]),
        )
    return _FIXED_CODES


def _fixed_tables():
    global _FIXED_LIT_DT, _FIXED_DIST_DT
    if _FIXED_LIT_DT is None:
        _FIXED_LIT_DT = huffman.build_decode_table(tables.FIXED_LIT_LENGTHS, huffman.ROOT_BITS_LENS)
        _FIXED_DIST_DT = huffman.build_decode_table(tables.FIXED_DIST_LENGTHS, huffman.ROOT_BITS_DISTS)
    return _FIXED_LIT_DT, _FIXED_DIST_DT


# ---------------------------------------------------------------------------
# One-shot inflate on the host: the native state machine (native/tpuz.cpp,
# a copy of the reference's), as the reference runs it; the reference has
# no device one-shot inflate.  _inflate_python is the plain version the
# tests hold it to.
# ---------------------------------------------------------------------------


def inflate(data, *, window: np.ndarray | None = None,
            window_bits: int = 15) -> bytes:
    """One-shot raw-DEFLATE decode on the host.

    ``window`` optionally seeds the 32 KiB back-reference history
    (a preset dictionary).  ``window_bits`` (8..15) restricts
    back-reference distances to the negotiated window: a stream that
    references past it fails with "invalid distance".  Raises
    :class:`MalformedError` on invalid input.
    """
    out, _ = inflate_ex(data, window=window, window_bits=window_bits)
    return out


def inflate_ex(data, *, window: np.ndarray | None = None,
               window_bits: int = 15):
    """Like :func:`inflate` but also returns bytes consumed."""
    return _inflate_native(_np_u8(data), window, window_bits)


def _inflate_ex_arr(data, *, window: np.ndarray | None = None,
                    window_bits: int = 15) -> tuple[np.ndarray, int]:
    """Like :func:`inflate_ex` but returns the payload as a numpy uint8
    array (zero-copy from the native decoder) so framing layers can
    checksum and assemble without materializing intermediate bytes."""
    return _inflate_native_arr(_np_u8(data), window, window_bits)


def inflate_into(data, dst: np.ndarray, *, window: np.ndarray | None = None,
                 window_bits: int = 15) -> tuple[int, int]:
    """One-shot inflate into a caller-owned buffer; returns
    (bytes_consumed, bytes_produced).  Raises :class:`MalformedError`,
    including when ``dst`` is too small."""
    out, consumed = inflate_ex(data, window=window, window_bits=window_bits)
    if len(out) > dst.size:
        raise MalformedError("unexpected end of output")
    dst[: len(out)] = np.frombuffer(out, np.uint8)
    return consumed, len(out)


def _inflate_native(buf: np.ndarray, window, window_bits: int = 15) -> tuple[bytes, int]:
    out, consumed = _inflate_native_arr(buf, window, window_bits)
    return out.tobytes(), consumed


def _inflate_native_arr(buf: np.ndarray, window,
                        window_bits: int = 15) -> tuple[np.ndarray, int]:
    """Native one-shot inflate returning a numpy uint8 view (no copy);
    framing layers checksum/concatenate the array and materialize
    bytes once at the API boundary."""
    inf = native.InflateStream()
    if window_bits != 15:
        inf.set_window_bits(window_bits)
    if window is not None:
        inf.set_dictionary(bytes(window))
    if not buf.flags["C_CONTIGUOUS"]:
        buf = np.ascontiguousarray(buf)
    pos = 0
    # uninitialized output buffer, grown geometrically on FLUSH
    out = np.empty(max(4 * buf.size, 1 << 16), dtype=np.uint8)
    out_pos = 0
    while True:
        status, consumed, produced = inf.run_into(buf[pos:], out, out_pos)
        pos += consumed
        out_pos += produced
        if status == native.InflateStream.END:
            return out[:out_pos], pos - len(inf.takeback())
        if status == native.InflateStream.MALFORMED:
            raise MalformedError(inf.error)
        if status == native.InflateStream.AWAIT and pos >= buf.size:
            raise MalformedError("unexpected end of input")
        if status == native.InflateStream.FLUSH:
            bigger = np.empty(out.size * 2, dtype=np.uint8)
            bigger[:out_pos] = out[:out_pos]
            out = bigger
        # AWAIT with more input: loop


def _inflate_python(data, *, window: np.ndarray | None = None,
                    window_bits: int = 15):
    """The plain table-driven decoder: (payload bytes, bytes consumed)."""
    win_limit = 1 << window_bits
    r = bitstream.BitReader(_np_u8(data))
    out = bytearray()
    if window is not None:
        out.extend(bytes(window))
    prefix = len(out)
    try:
        while True:
            bfinal = r.read(1)
            btype = r.read(2)
            if btype == 3:
                raise MalformedError("invalid kind of block")
            if btype == 0:
                r.align_to_byte()
                ln = int.from_bytes(r.read_bytes(2).tobytes(), "little")
                nlen = int.from_bytes(r.read_bytes(2).tobytes(), "little")
                if ln != (nlen ^ 0xFFFF):
                    raise MalformedError("invalid complement of length")
                out.extend(r.read_bytes(ln).tobytes())
            else:
                if btype == 1:
                    lit_dt, dist_dt = _fixed_tables()
                else:
                    lit_dt, dist_dt = _build_tables_from_header(r)
                while True:
                    sym, nb = huffman.decode_one(lit_dt, r.peek(15))
                    if sym < 0:
                        raise MalformedError("invalid literal/length")
                    r.consume(nb)
                    if sym == EOB:
                        break
                    if sym < 256:
                        out.append(sym)
                        continue
                    if sym > 285:
                        raise MalformedError("invalid literal/length")
                    lcode = sym - 257
                    length = int(LENGTH_BASE[lcode]) + r.read(int(LENGTH_EXTRA[lcode]))
                    dsym, dnb = huffman.decode_one(dist_dt, r.peek(15))
                    if dsym < 0 or dsym > 29:
                        raise MalformedError("invalid distance code")
                    r.consume(dnb)
                    dist = int(DIST_BASE[dsym]) + r.read(int(DIST_EXTRA[dsym]))
                    if dist > len(out) or dist > win_limit:
                        raise MalformedError("invalid distance")
                    # copy with overlap semantics; doubling keeps this O(log)
                    src = len(out) - dist
                    if dist >= length:
                        out += out[src : src + length]
                    else:
                        chunk = bytes(out[src:])
                        while len(chunk) < length:
                            chunk = chunk + chunk
                        out += chunk[:length]
            if bfinal:
                break
    except EOFError as e:
        raise MalformedError("unexpected end of input") from e
    return bytes(out[prefix:]), r.byte_position()


# ---------------------------------------------------------------------------
# One-shot deflate on the card.
# ---------------------------------------------------------------------------


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
            config=None, device="cuda") -> bytes:
    """One-shot DEFLATE compress (level 0 = stored), byte-identical to
    ``decompress_tpu.de.deflate`` with the same arguments.

    ``dynamic=False`` or ``strategy="fixed"`` forces fixed-Huffman
    blocks; ``window_bits`` (8..15) restricts match distances;
    ``dictionary`` seeds the match window; the default level is 6.
    Unknown levels raise ValueError.  A ``config``
    (``utils.config.CodecConfig``, validated first) supplies level,
    segment size, ``dynamic`` and window bits where those arguments are
    not given, and its device where ``device`` is left at "cuda"."""
    # explicit arguments win over the config object, which wins over
    # the built-in defaults
    if config is not None:
        config.validate()
        level = config.level if level is None else level
        segment_size = segment_size or config.segment_size
        dynamic = config.dynamic_blocks if dynamic is None else dynamic
        window_bits = config.window_bits if window_bits is None else window_bits
        device = config.device if device == "cuda" else device
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
    nseg = (n + seg - 1) // seg
    head = None
    if dictionary:
        d = _np_u8(dictionary)
        head = d[-min(d.size, tables.WINDOW_SIZE):]
    _deflate_pipelined(w, arr, nseg, level, seg, dev,
                       force_block=None if dynamic else "fixed",
                       window_bits=window_bits, dict_hist=head)
    with profiling.span("schedule.assemble"):
        return w.getvalue()


#: batches whose round A is dispatched ahead of the host's planning stage
#: (bounds device memory while letting the card's analysis overlap the
#: host's tree building and transfers)
PIPELINE_DEPTH = 4


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
    dlen = 0 if dict_hist is None else dict_hist.size
    chunks, hists = [], []
    for s in range(seg_lo, seg_hi):
        start = s * seg
        hl = _history_len(start, dlen)
        head = np.zeros(lz77.HIST, dtype=np.uint8)
        _fill_history(head, arr, start, hl, dict_hist)
        chunks.append(arr[start: start + seg])
        hists.append(head[lz77.HIST - hl:])
    data, n_valid, hist_len = _history_rows(chunks, hists, seg)
    return data, n_valid, hist_len, seg_hi - seg_lo


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


def _deflate_pipelined(w, arr, nseg, level, seg, dev, force_block=None,
                       window_bits=15, dict_hist=None):
    """Analyze, repair, plan and pack every batch of segments, with round A
    of the next ``PIPELINE_DEPTH`` batches dispatched ahead: first round A
    of the first batches, then for each batch in order, round A of the
    next one, then the oldest in flight's finish (repairs, round B) and
    its host half (:func:`_finish_batch`).  One stream carries it all, so
    a batch's round B is queued behind the later batches' round A.  On
    CUDA no host read blocks the stream: each waits on its own batch's
    event (``ops/transfer``)."""
    batches = [(lo, min(lo + MAX_DEVICE_BATCH, nseg))
               for lo in range(0, nseg, MAX_DEVICE_BATCH)]

    def dispatch(lo, hi):
        keep = []  # the uploads' pinned sources, held until the batch is finished
        with profiling.span("schedule.stage"):
            if seg >= lz77.HIST:
                payload, head, n_valid, hist_len, _ = _build_batch_payload(
                    arr, lo, hi, seg, dict_hist)
                d_data = _assemble_batch_device(transfer.upload(payload, dev, keep),
                                                transfer.upload(head, dev, keep))
            else:
                data, n_valid, hist_len, _ = _build_batch(arr, lo, hi, seg, dict_hist)
                d_data = transfer.upload(data, dev, keep)
            d_nv = transfer.upload(n_valid, dev, keep)
            d_hl = transfer.upload(hist_len, dev, keep)
            res = lz77.analyze2_start(d_data, d_nv, d_hl, level=level, seg_len=seg,
                                      window_bits=window_bits)
        return lo, hi, n_valid, d_data, d_nv, d_hl, res, keep

    inflight = collections.deque(dispatch(*bt) for bt in batches[:PIPELINE_DEPTH])
    ahead = iter(batches[len(inflight):])
    for _ in batches:
        lo, hi, n_valid, d_data, d_nv, d_hl, res, _keep = inflight.popleft()
        nxt = next(ahead, None)
        if nxt is not None:
            inflight.append(dispatch(*nxt))
        res = lz77.analyze2_finish(res, d_data, d_nv, d_hl, level=level,
                                   seg_len=seg, window_bits=window_bits)
        final_flags = np.arange(lo, hi) == nseg - 1
        _finish_batch(w, arr, lo, final_flags, seg, n_valid, d_data, res,
                      force_block)


def _finish_batch(w, arr, seg_lo, final_flags, seg, n_valid, d_data, res,
                  force_block=None):
    """Host half of one batch of ``len(final_flags)`` segments, the first
    at ``arr[seg_lo * seg:]``: block planning, device pack, assembly.
    The host reads (histograms, then the pack's totals and every word
    column) go through events (``ops/transfer``)."""
    b = len(final_flags)
    b_pad = d_data.shape[0]
    hist_lit, hist_dist = transfer.read(res, "hist_lit", "hist_dist")
    (hdr_vals, hdr_bits), tabs, kinds = plan_blocks(
        hist_lit[:b], hist_dist[:b], n_valid[:b], final_flags, pad_to=b_pad,
        force_block=force_block)
    # any packed (non-stored) block beat the stored cost, so < ~9 bits/byte
    out_words = (9 * seg) // 32 + 2 * _HDR_PAD
    words, totals = pack_segments(res, d_data[:, lz77.HIST:], hdr_vals,
                                  hdr_bits, *tabs, out_words=out_words)
    # all columns: the copy need not wait for the totals to reach the host
    totals, words = transfer.Fetch({"totals": totals, "words": words}).wait(
        "totals", "words")
    with profiling.span("schedule.assemble"):
        # keep only the words used by non-stored segments
        used = [int(totals[i]) for i in range(b) if kinds[i] != "stored"]
        cap = (max(used) + 31) // 32 + 1 if used else 0
        words = words[:, :cap].astype("<u4")
        for i in range(b):
            if kinds[i] == "stored":
                start = (seg_lo + i) * seg
                _emit_stored(w, arr[start: start + int(n_valid[i])],
                             final=bool(final_flags[i]))
            else:
                w.write_packed(words[i].view(np.uint8), int(totals[i]))


def pack_segments(res, sym_lit, hdr_vals, hdr_bits, lit_codes, lit_bits,
                  dist_codes, dist_bits, eob_vals, eob_bits, *, out_words: int,
                  n_splits: int = 0, split_stride: int = 2048,
                  split_bits: int = 0):
    """The pack of one batch: the tables uploaded, then :func:`pack_device`.

    ``res`` holds the parse arrays (on_path, is_match, length, dist) on
    the device of ``sym_lit`` (uint8[B, seg] payload bytes); the header
    and code tables are plan_blocks' numpy arrays.  Returns
    (words int64[B, out_words] of uint32 values, total_bits int64[B]);
    with ``n_splits > 1`` also the split points of the member-parallel
    decoder, as ``(packed, splits)``: see :func:`split_points`."""
    dev = sym_lit.device

    def put(a):
        return transfer.upload(a, dev)

    return pack_device(
        res["on_path"], res["is_match"], res["length"], res["dist"], sym_lit,
        put((lit_codes.astype(np.int32) << 4) | lit_bits),
        put((dist_codes.astype(np.int32) << 4) | dist_bits),
        put(hdr_vals.astype(np.int64)), put(hdr_bits), put(eob_vals.astype(np.int64)),
        put(eob_bits), out_words=out_words, n_splits=n_splits,
        split_stride=split_stride, split_bits=split_bits)


@graphs.program(static=("out_words", "n_splits", "split_stride", "split_bits"))
def pack_device(on_path, is_match, length, dist, sym_lit, lit_cb, dist_cb, hdr_vals,
                hdr_bits, eob_vals, eob_bits, *, out_words: int, n_splits: int = 0,
                split_stride: int = 2048, split_bits: int = 0):
    """The pack's device half (the reference's ``_get_pack_jit``): the
    slot build, the plane bit pack and, with ``n_splits > 1``, the split
    points; the code tables are packed ``code << 4 | len`` (int32[B, 286]
    and [B, 30]).  Returns what :func:`pack_segments` does."""
    v01, n01, v23, n23 = pack_cu.build_slots(on_path, is_match, length, dist, sym_lit,
                                             lit_cb, dist_cb)
    words, total, boff, posbits = bitpack.pack_slot_planes(
        v01, n01, v23, n23, hdr_vals, hdr_bits, eob_vals, eob_bits, out_words)
    if n_splits <= 1:
        return words, total
    return (words, total), split_points(
        on_path, is_match, length, boff, posbits, n_splits=n_splits,
        split_stride=split_stride, split_bits=split_bits)


def split_points(on_path, is_match, length, boff, posbits, *, n_splits: int,
                 split_stride: int, split_bits: int):
    """The split-point writer (the ``n_splits > 1`` tail of the
    reference's pack): for each of the ``n_splits - 1`` interior
    boundaries, the command that owns it — its bit offset in the packed
    body, its command index and its output offset — plus each member's
    command count with the EOB.

    With ``split_bits`` boundary j is the command whose bit span contains
    ``j * split_bits``; otherwise it is the command with exclusive index
    ``j * split_stride``.  Either key is monotone over positions, so the
    owner is the last position with ``key <= q_j`` (a binary search; -1
    when the boundary lies before the first command).  Bit offset 0
    marks "no split" (real offsets are >= 3 header bits).

    Returns (bits, cmds, outs) int64[B, n_splits - 1] and ncmds int64[B].
    """
    on_i = on_path.to(torch.int64)
    adv = torch.where(on_path, torch.where(is_match, length.to(torch.int64), 1), 0)
    opos = torch.cumsum(adv, 1) - adv
    cmdi = torch.cumsum(on_i, 1) - on_i
    nslots = n_splits - 1
    qs = torch.arange(1, nslots + 1, device=boff.device, dtype=torch.int64)
    qs = qs * (split_bits if split_bits else split_stride)
    key = boff if split_bits else cmdi
    idx = torch.searchsorted(key.contiguous(),
                             qs.expand(key.shape[0], nslots).contiguous(),
                             right=True) - 1
    safe = torch.clamp(idx, min=0)

    def take(a):
        return torch.gather(a, 1, safe)

    sel = (idx >= 0) & take(on_path) & (take(cmdi) > 0)
    if split_bits:
        # valid iff the found command really contains the boundary
        sel &= (take(boff) <= qs) & (take(boff) + take(posbits) > qs)
    else:
        sel &= take(cmdi) == qs

    def pick(a):
        return torch.where(sel, take(a), 0)

    ncmds = on_i.sum(1) + 1
    return pick(boff), pick(cmdi), pick(opos), ncmds


# ---------------------------------------------------------------------------
# Building blocks of the streaming codecs (``streaming.py``): the host
# command encoder and its oracle, and the device match finder and segment
# encoder, with the reference's arguments and a ``device``.
# ---------------------------------------------------------------------------


def reconstruct(cmds: list[int]) -> bytes:
    """Apply a command list: literals append, copies re-read earlier
    output; stops at EOB."""
    out = bytearray()
    for c in cmds:
        kind, arg = cmd_unpack(c)
        if kind == "literal":
            out.append(arg)
        elif kind == "copy":
            off, ln = arg
            if off > len(out):
                raise MalformedError("invalid distance")
            src = len(out) - off
            for k in range(ln):
                out.append(out[src + k])
        else:
            break
    return bytes(out)


def encode_blocks(blocks: list, *, final: bool = True) -> bytes:
    """Encode a sequence of (cmds, kind) pairs as chained DEFLATE blocks
    (kind: 'fixed' | 'dynamic' | None for the cost choice)."""
    w = bitstream.BitWriter()
    for bi, (cmds, kind) in enumerate(blocks):
        last = final and bi == len(blocks) - 1
        _encode_one_block(w, cmds, kind, last)
    return w.getvalue()


def encode_commands(cmds: list[int], *, block: str | None = None,
                    final: bool = True) -> bytes:
    """Entropy-encode a command list as one DEFLATE block on the host.
    ``block`` forces 'fixed' or 'dynamic' (default: the exact cost
    choice)."""
    w = bitstream.BitWriter()
    _encode_one_block(w, cmds, block, final)
    return w.getvalue()


def _encode_one_block(w: bitstream.BitWriter, cmds: list[int],
                      block: str | None, final: bool) -> None:
    cmds = [c for c in cmds if c != CMD_EOB]
    hist_lit = np.zeros(NUM_LIT_SYMS, dtype=np.int64)
    hist_dist = np.zeros(NUM_DIST_SYMS, dtype=np.int64)
    hist_lit[EOB] = 1
    lits, lens_, dists = [], [], []
    for c in cmds:
        kind, arg = cmd_unpack(c)
        if kind == "literal":
            hist_lit[arg] += 1
            lits.append(arg)
            lens_.append(0)
            dists.append(0)
        else:
            off, ln = arg
            sym = 257 + int(tables.length_to_code(np.array([ln]))[0])
            hist_lit[sym] += 1
            hist_dist[int(tables.dist_to_code(np.array([off]))[0])] += 1
            lits.append(-1)
            lens_.append(ln)
            dists.append(off)

    dyn_lit = huffman.code_lengths_from_frequencies(hist_lit)
    dyn_dist = huffman.code_lengths_from_frequencies(hist_dist)
    header = build_dynamic_header(dyn_lit, dyn_dist)
    cost_dyn = header.bit_length + symbol_cost_bits(hist_lit, hist_dist, dyn_lit, dyn_dist)
    cost_fix = symbol_cost_bits(hist_lit, hist_dist, _FIXED_LIT_BITS, _FIXED_DIST_BITS)
    kind = block or ("fixed" if cost_fix <= cost_dyn else "dynamic")

    w.write(1 if final else 0, 1)
    if kind == "fixed":
        w.write(1, 2)
        ll, dl = tables.FIXED_LIT_LENGTHS, tables.FIXED_DIST_LENGTHS
    else:
        w.write(2, 2)
        ll, dl = dyn_lit, dyn_dist
        packed, total = bitstream.pack_bits(header.values, header.nbits)
        w.write_packed(packed, total)
    lc = huffman.canonical_codes(ll)
    dc = huffman.canonical_codes(dl)
    for i, c in enumerate(cmds):
        if lits[i] >= 0:
            w.write(int(lc[lits[i]]), int(ll[lits[i]]))
        else:
            ln, off = lens_[i], dists[i]
            lcode = int(tables.length_to_code(np.array([ln]))[0])
            sym = 257 + lcode
            w.write(int(lc[sym]), int(ll[sym]))
            w.write(ln - int(LENGTH_BASE[lcode]), int(LENGTH_EXTRA[lcode]))
            dcode = int(tables.dist_to_code(np.array([off]))[0])
            w.write(int(dc[dcode]), int(dl[dcode]))
            w.write(off - int(DIST_BASE[dcode]), int(DIST_EXTRA[dcode]))
    w.write(int(lc[EOB]), int(ll[EOB]))


def _history_rows(chunks, hists, seg: int):
    """One row per chunk, each behind the last HIST bytes of its own
    history, padded to ``_batch_rows`` rows (the reference pads to
    MAX_DEVICE_BATCH; rows are analysed independently, so only the work
    differs).  Returns (data uint8[b_pad, HIST + seg], n_valid, hist_len)."""
    b_pad = _batch_rows(len(chunks))
    data = np.zeros((b_pad, lz77.HIST + seg), dtype=np.uint8)
    n_valid = np.zeros(b_pad, dtype=np.int32)
    hist_len = np.zeros(b_pad, dtype=np.int32)
    for i, (c, h) in enumerate(zip(chunks, hists)):
        c, h = _np_u8(c), _np_u8(h)
        if c.size > seg:
            raise ValueError("chunk larger than segment")
        hl = min(h.size, lz77.HIST)
        if hl:
            data[i, lz77.HIST - hl: lz77.HIST] = h[h.size - hl:]
        data[i, lz77.HIST: lz77.HIST + c.size] = c
        n_valid[i] = c.size
        hist_len[i] = hl
    return data, n_valid, hist_len


def _analyze_rows(data, n_valid, hist_len, level: int, seg: int, dev):
    """The rows on ``dev`` and their full analysis (``lz77.analyze2``)."""
    d_data = torch.from_numpy(data).to(dev)
    res = lz77.analyze2(d_data, torch.from_numpy(n_valid).to(dev),
                        torch.from_numpy(hist_len).to(dev), level=level,
                        seg_len=seg)
    return d_data, res


def match_commands(chunk: bytes, hist: bytes = b"", level: int = 6,
                   seg: int | None = None, *, device="cuda") -> np.ndarray:
    """Match-find one chunk (with history) into packed commands
    (the queue's int packing; no EOB appended)."""
    return match_commands_batch([chunk], [hist], level, seg, device=device)[0]


def match_commands_batch(chunks: list[bytes], hists: list[bytes],
                         level: int = 6, seg: int | None = None, *,
                         device="cuda") -> list[np.ndarray]:
    """Match-find up to MAX_DEVICE_BATCH chunks, each with its history,
    in one device call; one int64 command array per chunk.  ``seg``
    defaults to 16,384, doubled until the longest chunk fits."""
    dev = _resolve_device(device)
    b = len(chunks)
    if b > MAX_DEVICE_BATCH:
        raise ValueError("too many chunks for one device call")
    if seg is None:
        seg = 16384
        while seg < max(len(c) for c in chunks):
            seg *= 2
    data, n_valid, hist_len = _history_rows(chunks, hists, seg)
    _, res = _analyze_rows(data, n_valid, hist_len, level, seg, dev)
    on_path = res["on_path"].cpu().numpy()
    is_match = res["is_match"].cpu().numpy()
    length = res["length"].cpu().numpy()
    dist = res["dist"].cpu().numpy()
    out = []
    for i in range(b):
        n = int(n_valid[i])
        pos = np.flatnonzero(on_path[i, :n])
        im = is_match[i, pos].astype(bool)
        ln64 = length[i, pos].astype(np.int64)
        d64 = dist[i, pos].astype(np.int64)
        lits = data[i, lz77.HIST + pos].astype(np.int64)
        out.append(np.where(
            im, ((ln64 - MIN_MATCH) << 16) | (d64 - 1) | _CMD_COPY_FLAG, lits))
    return out


def deflate_segment_into(w: bitstream.BitWriter, chunk: bytes, hist: bytes,
                         level: int, seg: int, final: bool, *,
                         device="cuda") -> None:
    """Encode one segment behind its history (the last 32 KiB of
    ``hist``), appending its blocks to the open writer ``w``: the
    streaming encoder's backend, one device analysis per segment."""
    dev = _resolve_device(device)
    data, n_valid, hist_len = _history_rows([chunk], [hist], seg)
    d_data, res = _analyze_rows(data, n_valid, hist_len, level, seg, dev)
    _finish_batch(w, _np_u8(chunk), 0, np.array([final]), seg, n_valid,
                  d_data, res)
