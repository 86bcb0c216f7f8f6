"""Round-B bit costs on the card: literal bits and match gains.

Round B (``lz77.lz77_parse_cost``) re-parses round A's candidates with
exact bit costs from per-segment code-length tables (``lcost[b, 286]``
for literals and length codes, ``dcost[b, 30]`` for distance codes):

* ``litbits[b, i] = lcost[b, lit[b, i]]``, the bits of a literal, and
  ``pref``, their exclusive prefix sum (``pref[b, 0] = 0``,
  ``pref[b, i + 1] = pref[b, i] + litbits[b, i]``), from one call;
* ``gain[b, i]`` = the literal bits a match saves minus what it costs:
  ``pref[i + len] - pref[i] - (lcost[257 + lcode] + lext + dcost[dcode]
  + dext)`` with ``pref`` the exclusive prefix sum of ``litbits``
  (``i + len`` capped at T), ``NEG_GAIN`` where ``len < 3``; with a hot
  lane the hot candidate replaces the round-A one on a strictly greater
  gain.

Replaces ``decompress_tpu/ops/cost_pl.py: litbits_pl`` and ``gain_pl``
(``_litbits_kernel``, ``_gain_kernel``), and the prefix sum between
them, with ``csrc/cost.cu``.  The TPU kernels' padded tables, select
trees and 512-wide prefix slabs are TPU artefacts: here each block
stages its segment's tables in shared memory, the prefix sum is one
int32[B, T + 1] array in device memory, and any B and T are taken.  Both
are bound by device memory (9 bytes per position for the literal bits
and their prefix; 28, or 36 with the hot lane, for gain): the literal
bits are a reduce-then-scan over 4096-position tiles in one C call (two
launches, counted as one), gain one pass with one thread per position;
reads and writes are coalesced and every table read is in shared
memory.  The plain versions are the integer form of the reference's XLA
branch (``lz77.lz77_parse_cost``'s ``match_cost``/``match_gain`` and
its cumsum).
"""

from __future__ import annotations

import torch

from ..core.tables import NUM_DIST_SYMS, NUM_LIT_SYMS

from .. import _build
from . import codes

#: "no match" gain (copy of the reference's ``cost_pl.NEG_GAIN``)
NEG_GAIN = -(1 << 29)


#: positions per block of the literal-bits scan (``kScanTile`` in csrc/cost.cu)
LITBITS_TILE = 4096


def litbits_pref_plain(lit, lcost):
    """(litbits int32[B, T], pref int32[B, T + 1]) by a gather and a
    cumsum; see :func:`litbits_pref`."""
    bits = torch.gather(lcost, 1, lit.to(torch.int64))
    pref = torch.cat([torch.zeros_like(bits[:, :1]),
                      torch.cumsum(bits, 1, dtype=torch.int32)], 1)
    return bits, pref


def litbits_pref(lit, lcost):
    """Literal bits of a batch and their exclusive prefix sum: lit
    uint8[B, T] (the payload bytes; rows may be a strided view), lcost
    int32[B, 286] -> (litbits int32[B, T], pref int32[B, T + 1]).  A CPU
    tensor takes :func:`litbits_pref_plain`; a CUDA tensor launches the
    kernel (or raises)."""
    if lit.device.type == "cpu":
        return litbits_pref_plain(lit, lcost)
    b, t = lit.shape
    _build.check_rows("lit", lit, torch.uint8, (b, t))
    _build.check_cuda("lcost", lcost, torch.int32, (b, NUM_LIT_SYMS))
    bits = torch.empty((b, t), dtype=torch.int32, device=lit.device)
    pref = torch.empty((b, t + 1), dtype=torch.int32, device=lit.device)
    tile_sums = torch.empty((b, max(1, -(-t // LITBITS_TILE))),
                            dtype=torch.int32, device=lit.device)
    err = _build.lib().dtt_litbits_pref(
        lit.data_ptr(), lit.stride(0), lcost.data_ptr(), tile_sums.data_ptr(),
        bits.data_ptr(), pref.data_ptr(), b, t, _build.stream(lit))
    _build.launched("litbits", err)
    return bits, pref


def _gain_plain(length, dist, pref, lcost, dcost):
    lcode, lex, _ = codes.length_code_parts(length)
    dcode, dex, _ = codes.dist_code_parts(dist)
    cost = (torch.gather(lcost, 1, (257 + lcode).to(torch.int64)) + lex
            + torch.gather(dcost, 1, dcode.to(torch.int64)) + dex)
    t = length.shape[1]
    pos = torch.arange(t, device=length.device)
    end = torch.clamp(pos + length, 0, t)
    span = torch.gather(pref, 1, end) - pref[:, :t]
    return torch.where(length >= codes.MIN_MATCH, span - cost, NEG_GAIN)


def gain_plain(length, dist, hot_len, hot_dist, pref, lcost, dcost):
    """(length, dist, gain) int32[B, T] by table gathers; see
    :func:`gain`."""
    g = _gain_plain(length, dist, pref, lcost, dcost)
    if hot_len is None:
        return length, dist, g
    gh = _gain_plain(hot_len, hot_dist, pref, lcost, dcost)
    better = gh > g
    return (torch.where(better, hot_len, length),
            torch.where(better, hot_dist, dist), torch.where(better, gh, g))


def gain(length, dist, hot_len, hot_dist, pref, lcost, dcost):
    """Match gains of a batch, merged with the optional hot lane:
    length/dist int32[B, T] (round-A candidates, masked by the caller),
    hot_len/hot_dist int32[B, T] or both None, pref int32[B, T + 1]
    (exclusive prefix sum of the literal bits), lcost int32[B, 286],
    dcost int32[B, 30].  Returns (length, dist, gain) int32[B, T].  A
    CPU tensor takes :func:`gain_plain`; a CUDA tensor launches the
    kernel (or raises)."""
    if (hot_len is None) != (hot_dist is None):
        raise ValueError("gain: hot_len and hot_dist go together")
    if length.device.type == "cpu":
        return gain_plain(length, dist, hot_len, hot_dist, pref, lcost, dcost)
    b, t = length.shape
    args = [("length", length, (b, t)), ("dist", dist, (b, t)),
            ("pref", pref, (b, t + 1)), ("lcost", lcost, (b, NUM_LIT_SYMS)),
            ("dcost", dcost, (b, NUM_DIST_SYMS))]
    if hot_len is not None:
        args += [("hot_len", hot_len, (b, t)), ("hot_dist", hot_dist, (b, t))]
    for name, a, shape in args:
        _build.check_cuda(name, a, torch.int32, shape)
    out = [torch.empty((b, t), dtype=torch.int32, device=length.device)
           for _ in range(3)]
    err = _build.lib().dtt_gain(
        length.data_ptr(), dist.data_ptr(),
        None if hot_len is None else hot_len.data_ptr(),
        None if hot_dist is None else hot_dist.data_ptr(),
        pref.data_ptr(), lcost.data_ptr(), dcost.data_ptr(),
        *(o.data_ptr() for o in out), b, t, _build.stream(length))
    _build.launched("gain", err)
    return tuple(out)
