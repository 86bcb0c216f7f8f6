"""LZO1X block codec (counterpart of ``decompress_tpu/lzo.py``).

``uncompress`` (through the native decoder of ``native/``),
``uncompress_with_buffer`` (the growable-output host decoder),
``uncompress_into``, ``compress`` and ``make_wrkmem``.  The opcode
grammar is the classic LZO1X instruction set: first-byte literal runs,
M1/M2/M3/M4 matches with 2-bit trailing-literal state carry, 255-run
extended lengths, and the M4 dist==16384 end marker.

Match finding runs on the card with DEFLATE's match finder
(``ops/lz77.analyze``: the mark-path and histogram kernels), in batches
of ``de.MAX_DEVICE_BATCH`` segments of ``de.SEGMENT_SIZE`` bytes behind
32 KiB of history; the byte-oriented opcode emission and the decoders are
host code.  The bytes equal the reference's for the same level.
"""

from __future__ import annotations

import numpy as np
import torch

from . import de, native
from .ops import lz77 as lz77_ops
from .ops import transfer


class LzoError(ValueError):
    """Malformed LZO data."""


M4_MAX_DIST = 49151


class WrkMem:
    """Opaque work memory for compress; holds reusable scratch for the
    host emitter."""

    def __init__(self) -> None:
        self.scratch = bytearray(0x4000)


def make_wrkmem() -> WrkMem:
    return WrkMem()


# ---------------------------------------------------------------------------
# Decoder (host).
# ---------------------------------------------------------------------------


def _read_extended(buf: np.ndarray, ip: int, base: int) -> tuple[int, int]:
    """255-run extended length."""
    t = 0
    n = buf.size
    while ip < n and buf[ip] == 0:
        t += 255
        ip += 1
        if t > 2**24:
            raise LzoError("invalid extended length")
    if ip >= n:
        raise LzoError("unexpected end of input")
    t += base + int(buf[ip])
    return t, ip + 1


def uncompress(data, output: bytearray | None = None, *, max_size: int | None = None) -> bytes:
    """Decode one LZO1X block; raises :class:`LzoError` on malformed
    input.  With no ``output`` it runs the native decoder (the host
    library of ``native/``), else the Python state machine below, which
    documents the opcode grammar."""
    if output is None:
        cap = max_size if max_size is not None else max(64, len(bytes(data)) * 64)
        try:
            return native.lzo1x_decompress(data, cap)
        except native.LzoNativeError as e:
            if "-2" in str(e) and max_size is None:
                # output larger than the heuristic cap: retry big
                return native.lzo1x_decompress(data, 1 << 30)
            raise LzoError(str(e)) from e
    return _uncompress_python(data, output, max_size=max_size)


def _uncompress_python(data, output: bytearray | None = None, *,
                       max_size: int | None = None) -> bytes:
    buf = de._np_u8(data)
    n = buf.size
    out = bytearray() if output is None else output
    if n == 0:
        raise LzoError("unexpected end of input")
    ip = 0
    state = 0

    first = int(buf[ip])
    if first > 17:
        ip += 1
        t = first - 17
        if ip + t > n:
            raise LzoError("unexpected end of input")
        if max_size is not None and t > max_size:
            raise LzoError("output too large")
        out += buf[ip : ip + t].tobytes()
        ip += t
        state = 4 if t >= 4 else t

    while True:
        if ip >= n:
            raise LzoError("unexpected end of input")
        t = int(buf[ip])
        ip += 1
        if t < 16:
            if state == 0:
                # literal run
                if t == 0:
                    length, ip = _read_extended(buf, ip, 15)
                else:
                    length = t
                length += 3
                if ip + length > n:
                    raise LzoError("unexpected end of input")
                if max_size is not None and len(out) + length > max_size:
                    raise LzoError("output too large")
                out += buf[ip : ip + length].tobytes()
                ip += length
                state = 4
                continue
            if ip >= n:
                raise LzoError("unexpected end of input")
            nxt = int(buf[ip])
            ip += 1
            if state in (1, 2, 3):
                # M1: 2-byte match, short distance
                dist = (t >> 2) + (nxt << 2) + 1
                length = 2
            else:  # state == 4: M0 short match after literal run
                dist = (t >> 2) + (nxt << 2) + 2049
                length = 3
            s = t & 3
        elif t < 32:
            # M4: long-distance match / end marker
            length = t & 7
            if length == 0:
                length, ip = _read_extended(buf, ip, 7)
            length += 2
            if ip + 2 > n:
                raise LzoError("unexpected end of input")
            le16 = int(buf[ip]) | (int(buf[ip + 1]) << 8)
            ip += 2
            dist = 16384 + ((t & 8) << 11) + (le16 >> 2)
            s = le16 & 3
            if dist == 16384:
                break  # end marker
        elif t < 64:
            # M3
            length = t & 31
            if length == 0:
                length, ip = _read_extended(buf, ip, 31)
            length += 2
            if ip + 2 > n:
                raise LzoError("unexpected end of input")
            le16 = int(buf[ip]) | (int(buf[ip + 1]) << 8)
            ip += 2
            dist = (le16 >> 2) + 1
            s = le16 & 3
        else:
            # M2
            length = (t >> 5) + 1
            if ip >= n:
                raise LzoError("unexpected end of input")
            dist = ((t >> 2) & 7) + (int(buf[ip]) << 3) + 1
            ip += 1
            s = t & 3

        if dist > len(out):
            raise LzoError("out of bound")
        if max_size is not None and len(out) + length > max_size:
            raise LzoError("output too large")
        src = len(out) - dist
        if dist >= length:
            out += out[src : src + length]
        else:
            chunk = bytes(out[src:])
            while len(chunk) < length:
                chunk = chunk + chunk
            out += chunk[:length]
        if s:
            if ip + s > n:
                raise LzoError("unexpected end of input")
            if max_size is not None and len(out) + s > max_size:
                raise LzoError("output too large")
            out += buf[ip : ip + s].tobytes()
            ip += s
        # after a match: state = trailing-literal count (1..3) or 0;
        # state 4 only ever follows a standalone literal run
        state = s

    if ip != n:
        raise LzoError("trailing bytes after end marker")
    return bytes(out)


def uncompress_into(data, output: np.ndarray) -> int:
    """Decode into a caller-owned buffer; returns the byte count."""
    out = uncompress(data, max_size=int(output.size))
    output[: len(out)] = np.frombuffer(out, np.uint8)
    return len(out)


def uncompress_with_buffer(data) -> bytes:
    """Growable-output variant (the host state machine)."""
    return _uncompress_python(data, bytearray())


# ---------------------------------------------------------------------------
# Encoder: match finding on the card, opcode emission on the host.
# ---------------------------------------------------------------------------


def _emit_run(out: bytearray, arr: np.ndarray, lo: int, hi: int, first: bool) -> None:
    """Standalone literal run (legal at decoder state 0 / stream start)."""
    run = hi - lo
    if run == 0:
        return
    if first and run <= 238:
        out.append(run + 17)
    elif run < 4:
        raise AssertionError("short literal run mid-stream")  # by construction
    elif run <= 18:
        out.append(run - 3)
    else:
        out.append(0)
        rem = run - 18
        while rem > 255:
            out.append(0)
            rem -= 255
        out.append(rem)
    out += arr[lo:hi].tobytes()


def _emit_match(out: bytearray, arr: np.ndarray, dist: int, length: int,
                s: int, s_lo: int) -> None:
    """One M2/M3/M4 instruction with ``s`` (0..3) trailing literals."""
    if dist <= 2048 and 3 <= length <= 8:
        t = ((length - 1) << 5) | (((dist - 1) & 7) << 2) | s
        out.append(t)
        out.append((dist - 1) >> 3)
    elif dist <= 16384:
        base = length - 2
        if base < 32:
            out.append(32 | base)
        else:
            out.append(32)
            rem = base - 31
            while rem > 255:
                out.append(0)
                rem -= 255
            out.append(rem)
        le16 = ((dist - 1) << 2) | s
        out += bytes((le16 & 0xFF, le16 >> 8))
    else:
        d = dist - 16384
        base = length - 2
        t = 16 | ((d >> 11) & 8)
        if base < 8:
            out.append(t | base)
        else:
            out.append(t)
            rem = base - 7
            while rem > 255:
                out.append(0)
                rem -= 255
            out.append(rem)
        le16 = ((d & 0x3FFF) << 2) | s
        out += bytes((le16 & 0xFF, le16 >> 8))
    if s:
        out += arr[s_lo : s_lo + s].tobytes()


def compress(data, wrkmem: WrkMem | None = None, *, level: int = 6,
             device="cuda") -> bytes:
    """LZO1X compress; byte-identical to the reference's ``lzo.compress``
    at the same level.  Matches are found on ``device``; the opcodes are
    emitted on the host.  Output decodes with any LZO1X decoder.

    Emission invariants: a literal run of 1..3 only appears at stream
    start (first-byte form) or riding a match's 2 trailing-literal
    bits; standalone runs are always >= 4 and only occur at decoder
    state 0 (after a match with s == 0 or at stream start).
    """
    dev = de._resolve_device(device)
    arr = de._np_u8(data)
    n = arr.size
    out = bytearray()
    if n == 0:
        out += bytes((0x11, 0x00, 0x00))  # just the end marker
        return bytes(out)

    on_path, is_match, length, dist = _analyze(arr, level, dev)

    match_pos = np.flatnonzero(is_match & on_path)
    lit_start = 0
    first = True
    i = 0
    nm = match_pos.size
    while i < nm:
        p = int(match_pos[i])
        ln = int(length[p])
        dd = int(dist[p])
        run = p - lit_start
        if run > 0:
            _emit_run(out, arr, lit_start, p, first)
            first = False
        first = False
        # trailing literals: gap to the next match (or EOF), if 1..3
        q = p + ln
        nxt = int(match_pos[i + 1]) if i + 1 < nm else n
        tail = nxt - q
        s = tail if 0 < tail < 4 else 0
        _emit_match(out, arr, dd, ln, s, q)
        lit_start = q + s
        i += 1
    if lit_start < n:
        _emit_run(out, arr, lit_start, n, first)
    out += bytes((0x11, 0x00, 0x00))
    return bytes(out)


def _analyze(arr: np.ndarray, level: int, dev: torch.device):
    """Match finding for LZO on ``dev``: ``lz77.analyze`` (round A made
    exact, no round B) of batches of up to MAX_DEVICE_BATCH segments of
    SEGMENT_SIZE bytes, each behind its 32 KiB of history (matches of
    length >= 3, distance <= 32768), staged as the compressor stages them
    (``de.batch_rows``, ``de.Batch``); the four result fields come to the
    host through one Fetch a batch."""
    n = arr.size
    seg = de.SEGMENT_SIZE
    nseg = (n + seg - 1) // seg
    keys = ("on_path", "is_match", "length", "dist")
    out = [np.zeros(n, bool), np.zeros(n, bool), np.zeros(n, np.int32), np.zeros(n, np.int32)]
    for lo in range(0, nseg, de.MAX_DEVICE_BATCH):
        hi = min(lo + de.MAX_DEVICE_BATCH, nseg)
        batch = de.Batch(de.batch_rows(*de._segments(arr, lo, hi, seg), seg), dev)
        res = lz77_ops.analyze(batch.data, batch.n_valid, batch.hist_len, level=level,
                               seg_len=seg)
        start, stop = lo * seg, min(hi * seg, n)
        for dst, got in zip(out, transfer.read(res, *keys)):
            dst[start:stop] = got[:hi - lo].reshape(-1)[:stop - start]
    return tuple(out)
