"""Raw DEFLATE (RFC 1951) one-shot compression on the card (torch).

Counterpart of ``decompress_tpu/de.py: deflate`` for levels 0-12 and the
``rle``/``huffman_only``/``fixed`` strategies.  The pipeline is the
reference's: device LZ77 analysis of up to ``MAX_DEVICE_BATCH`` segments
of ``SEGMENT_SIZE`` bytes, each with its 32 KiB history, with the
cost-aware round B at levels 5-12 (``ops/lz77.py``, ``ops/cost_cu.py``);
host block planning and Huffman tables (``plan_blocks``, one native call
a batch); device slot build and bit pack (``ops/pack_cu.py``,
``ops/bitpack.py``); host assembly.  Every compressor on the card runs
its batches through one path (:func:`batch_rows`, :class:`Batch`,
:func:`drain`, :func:`write_parts`).  Round A of the next
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
import typing

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
from .ops import bitpack, checksum, graphs, lz77, pack_cu, transfer
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

#: what each staged :class:`Batch` puts on the card, summed: ``batches``;
#: ``rows`` (padding included) and ``valid_rows``; ``payload_bytes``, the
#: valid rows' payload; ``row_bytes``, the rows' segment width each,
#: history excluded.  Always on.
BATCH_COUNTS: collections.Counter = collections.Counter()


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
    the reference's ``plan_blocks``' byte for byte.

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
    _deflate_pipelined(w, arr, nseg, level, seg, dev,
                       force_block=None if dynamic else "fixed", window_bits=window_bits,
                       dict_hist=_np_u8(dictionary) if dictionary else None)
    with profiling.span("schedule.assemble"):
        return w.getvalue()


#: batches whose round A is dispatched ahead of the host's planning stage
#: (bounds device memory while letting the card's analysis overlap the
#: host's tree building and transfers)
PIPELINE_DEPTH = 4


# ---------------------------------------------------------------------------
# The batch path of every compressor on the card (the one-shot, the
# archive, the streaming encoders and LZO): one row builder
# (:func:`batch_rows`), one batch record (:class:`Batch`), one drain
# (:func:`drain`) and one writer of its member parts (:func:`write_parts`).
# ---------------------------------------------------------------------------


class Rows(typing.NamedTuple):
    """A batch's host rows (:func:`batch_rows`): ``data``
    uint8[rows, off + seg] holds row i's payload at ``off`` (HIST where
    the rows carry their own history, else 0); ``head`` is the first
    row's history where the card puts the others together from the row
    before, else None; ``n_valid`` and ``hist_len`` are int32[rows]
    (``hist_len`` None for rows with no history); the first ``b`` rows
    hold a chunk, the rest pad the batch."""

    data: np.ndarray
    head: np.ndarray | None
    n_valid: np.ndarray
    hist_len: np.ndarray | None
    b: int
    off: int

    def payload(self, i: int) -> np.ndarray:
        return self.data[i, self.off:self.off + self.n_valid[i]]


def batch_rows(chunks, hists, seg: int, *, rows: int | None = None) -> Rows:
    """One row per chunk (at most ``seg`` bytes), behind the last HIST bytes
    of its history ``hists[i]``, padded to ``rows`` rows (by default the
    reference's shapes: MAX_DEVICE_BATCH, or the next power of two).

    The layout follows the input: with ``hists`` None, rows of payload
    alone (members with no history, analysed at ``hist=0``); where ``seg``
    is at least HIST and each row's history is the tail of the chunk
    before it, rows of payload and the first row's history (``head``), the
    other histories put together on the card; else rows that carry their
    own history."""
    hist = lz77.HIST
    chunks = [_np_u8(c) for c in chunks]
    b = len(chunks)
    rows = rows or (MAX_DEVICE_BATCH if b == MAX_DEVICE_BATCH else 1 << (b - 1).bit_length())
    n_valid = np.zeros(rows, dtype=np.int32)
    n_valid[:b] = [c.size for c in chunks]
    if n_valid.max() > seg:
        raise ValueError("chunk larger than segment")
    head = hist_len = None
    off = 0
    if hists is not None:
        hists = [_np_u8(h)[-hist:] for h in hists]
        hist_len = np.zeros(rows, dtype=np.int32)
        hist_len[:b] = [h.size for h in hists]
        if seg >= hist and all(c.size == seg and h.size == hist and np.array_equal(h, c[-hist:])
                               for c, h in zip(chunks, hists[1:])):
            head = np.zeros(hist, dtype=np.uint8)
            head[hist - hists[0].size:] = hists[0]
        else:
            off = hist
    data = np.zeros((rows, off + seg), dtype=np.uint8)
    for i, c in enumerate(chunks):
        if off:
            data[i, hist - hist_len[i]: hist] = hists[i]
        data[i, off: off + c.size] = c
    return Rows(data, head, n_valid, hist_len, b, off)


def _segments(arr, lo: int, hi: int, seg: int, head=None):
    """(chunks, hists) of segments ``lo``..``hi`` of ``arr`` (segment s is
    ``arr[s * seg:(s + 1) * seg]``), each history the HIST bytes before its
    segment, ``head`` (a preset dictionary) before ``arr[0]``."""
    chunks, hists = [], []
    for s in range(lo, hi):
        start = s * seg
        h = arr[max(0, start - lz77.HIST): start]
        if h.size < lz77.HIST and head is not None:
            h = np.concatenate([head[h.size - lz77.HIST:], h])
        chunks.append(arr[start: start + seg])
        hists.append(h)
    return chunks, hists


class Part(typing.NamedTuple):
    """One member of a drained batch: ``kind`` "stored" with its bytes in
    ``data``, or "packed" with ``bits`` packed bits in ``data`` (BFINAL
    included); packed with split points, ``splits`` holds the (bit,
    command, output) triples, an int64 [n_splits - 1, 3] array, and
    ``ncmds`` the commands with the EOB; and ``crc`` the member's CRC-32
    where the pack computed it."""

    kind: str
    data: np.ndarray
    bits: int
    final: bool
    splits: np.ndarray | None = None
    ncmds: int = 0
    crc: int | None = None


_SPLIT_KEYS = ("sp_bits", "sp_cmds", "sp_outs", "sp_n")


class Batch:
    """One batch of rows through the card, in the steps a schedule orders:
    the constructor stages the rows (every upload through
    ``transfer.upload``, the pinned sources held in ``keep`` until the
    batch is drained); :meth:`start` dispatches round A; :meth:`finish`
    makes it exact, runs round B at the two-round levels and reads the
    histograms; :meth:`pack` plans the blocks, packs them and queues one
    Fetch of what :func:`drain` reads.  ``first`` is the index of the
    batch's first row in its input."""

    def __init__(self, rows: Rows, dev: torch.device, first: int = 0):
        self.rows, self.first = rows, first
        self.seg = rows.data.shape[1] - rows.off
        BATCH_COUNTS.update(batches=1, rows=len(rows.n_valid), valid_rows=rows.b,
                            payload_bytes=int(rows.n_valid[:rows.b].sum()),
                            row_bytes=len(rows.n_valid) * self.seg)
        self.keep: list = []
        self.data = transfer.upload(rows.data, dev, self.keep)
        if rows.head is not None:  # row i's history is row i-1's payload tail
            head = transfer.upload(rows.head, dev, self.keep)
            hists = torch.cat([head[None], self.data[:-1, self.seg - lz77.HIST:]], 0)
            self.data = torch.cat([hists, self.data], 1)
        self.n_valid = transfer.upload(rows.n_valid, dev, self.keep)
        self.hist = 0 if rows.hist_len is None else lz77.HIST
        self.hist_len = (torch.zeros(len(rows.n_valid), dtype=torch.int32, device=dev)
                         if rows.hist_len is None else
                         transfer.upload(rows.hist_len, dev, self.keep))

    def start(self, level: int, window_bits: int = 15) -> Batch:
        """Round A, with no host sync (``lz77.analyze2_start``)."""
        self.level, self.window_bits = level, window_bits
        self.res = lz77.analyze2_start(self.data, self.n_valid, self.hist_len, level=level,
                                       seg_len=self.seg, window_bits=window_bits,
                                       hist=self.hist)
        return self

    def finish(self) -> Batch:
        """The repairs and round B (``lz77.analyze2_finish``), then the
        histograms of the valid rows on the host."""
        self.res = lz77.analyze2_finish(self.res, self.data, self.n_valid, self.hist_len,
                                        level=self.level, seg_len=self.seg,
                                        window_bits=self.window_bits, hist=self.hist)
        hist_lit, hist_dist = transfer.read(self.res, "hist_lit", "hist_dist")
        self.hist_lit, self.hist_dist = hist_lit[:self.rows.b], hist_dist[:self.rows.b]
        return self

    def pack(self, final, *, force_block=None, shared_tree=False, n_splits: int = 0,
             split_stride: int = 2048, split_bits: int = 0, crc: bool = False) -> Batch:
        """Plan the blocks (row i a final block where ``final[i]``), pack
        them (with the split points where ``n_splits > 1``; see
        :func:`pack_segments`), compute the rows' CRC-32s where ``crc``,
        and queue one Fetch of it all."""
        b = self.rows.b
        self.final, self.n_splits, self.crc = final, n_splits, crc
        (hdr_vals, hdr_bits), tabs, self.kinds = plan_blocks(
            self.hist_lit, self.hist_dist, self.rows.n_valid[:b], final,
            pad_to=len(self.rows.n_valid), force_block=force_block, shared_tree=shared_tree)
        # any packed (non-stored) block beat the stored cost, so < ~9 bits/byte
        out_words = (9 * self.seg) // 32 + 2 * _HDR_PAD
        sym_lit = self.data[:, self.hist:]
        packed = pack_segments(self.res, sym_lit, hdr_vals, hdr_bits, *tabs,
                               out_words=out_words, n_splits=n_splits,
                               split_stride=split_stride, split_bits=split_bits)
        (words, totals), splits = packed if n_splits > 1 else (packed, ())
        outs = {"totals": totals, "words": words, **dict(zip(_SPLIT_KEYS, splits))}
        if crc:
            outs["crcs"] = checksum.crc32_rows_device(sym_lit, self.n_valid)
        self.fetch = transfer.Fetch(outs)
        return self


def drain(batches) -> list[Part]:
    """The member parts of packed batches, in order: each batch's Fetch
    waited for, and its words cut once to the width the packed rows use."""
    parts = []
    for batch in batches:
        b, kinds = batch.rows.b, batch.kinds
        keys = ("totals", "words") + (_SPLIT_KEYS if batch.n_splits > 1 else ())
        got = dict(zip(keys, (a[:b] for a in batch.fetch.wait(*keys))))
        # the CRC-32s in a wait of their own: the archive's count of waits
        # (``transfer.COUNTS``) stays what it was
        crcs = batch.fetch.wait("crcs")[0][:b].tolist() if batch.crc else [None] * b
        splits, ncmds = [None] * b, [0] * b
        if batch.n_splits > 1:
            splits = np.stack([got[k] for k in _SPLIT_KEYS[:3]], -1).astype(np.int64)
            ncmds = got["sp_n"].tolist()
        totals = got["totals"].tolist()
        used = [totals[i] for i in range(b) if kinds[i] != "stored"]
        cap = (max(used) + 31) // 32 + 1 if used else 0
        words = got["words"][:, :cap].astype("<u4")
        for i in range(b):
            final = bool(batch.final[i])
            if kinds[i] == "stored":
                parts.append(Part("stored", batch.rows.payload(i), 0, final, crc=crcs[i]))
            else:
                parts.append(Part("packed", words[i].view(np.uint8), totals[i], final,
                                  splits[i], ncmds[i], crcs[i]))
    return parts


def write_parts(w: bitstream.BitWriter, parts, *, sync: bool = False) -> None:
    """Member parts into ``w``: a stored one as stored blocks, a packed one
    as its bits; with ``sync``, each packed part that is not final is
    followed by a sync flush (an empty stored block), so that the next
    starts on a byte."""
    for part in parts:
        if part.kind == "stored":
            _emit_stored(w, part.data, final=part.final)
            continue
        w.write_packed(part.data, part.bits)
        if sync and not part.final:
            _emit_stored(w, part.data[:0], final=False)


def _deflate_pipelined(w, arr, nseg, level, seg, dev, force_block=None,
                       window_bits=15, dict_hist=None):
    """Analyze, repair, plan and pack every batch of segments, with round A
    of the next ``PIPELINE_DEPTH`` batches dispatched ahead: first round A
    of the first batches, then for each batch in order, round A of the
    next one, then the oldest in flight's finish (repairs, round B), pack
    and drain.  One stream carries it all, so a batch's round B is queued
    behind the later batches' round A.  On CUDA no host read blocks the
    stream: each waits on its own batch's event (``ops/transfer``)."""
    batches = [(lo, min(lo + MAX_DEVICE_BATCH, nseg))
               for lo in range(0, nseg, MAX_DEVICE_BATCH)]

    def dispatch(lo, hi):
        with profiling.span("schedule.stage"):
            rows = batch_rows(*_segments(arr, lo, hi, seg, dict_hist), seg)
            return Batch(rows, dev, first=lo).start(level, window_bits)

    inflight = collections.deque(dispatch(*bt) for bt in batches[:PIPELINE_DEPTH])
    ahead = iter(batches[len(inflight):])
    for _ in batches:
        batch = inflight.popleft()
        nxt = next(ahead, None)
        if nxt is not None:
            inflight.append(dispatch(*nxt))
        last = np.arange(batch.first, batch.first + batch.rows.b) == nseg - 1
        batch.finish().pack(last, force_block=force_block)
        with profiling.span("schedule.assemble"):
            write_parts(w, drain([batch]))


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
    rows = batch_rows(chunks, hists, seg)
    batch = Batch(rows, dev).start(level).finish()
    on_path, is_match, length, dist = transfer.read(batch.res, "on_path", "is_match",
                                                    "length", "dist")
    out = []
    for i in range(b):
        n = int(rows.n_valid[i])
        pos = np.flatnonzero(on_path[i, :n])
        im = is_match[i, pos].astype(bool)
        ln64 = length[i, pos].astype(np.int64)
        d64 = dist[i, pos].astype(np.int64)
        lits = rows.payload(i)[pos].astype(np.int64)
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
    batch = Batch(batch_rows([chunk], [hist], seg), dev).start(level).finish()
    batch.pack(np.array([final]))
    with profiling.span("schedule.assemble"):
        write_parts(w, drain([batch]))
