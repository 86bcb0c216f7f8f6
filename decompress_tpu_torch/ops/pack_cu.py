"""Slot build: the two merged DEFLATE bit fields of every position.

For each payload position: ``v01/n01`` = the lit/len Huffman code with
the length extra bits above it, ``v23/n23`` = the distance code with the
distance extra bits above it, looked up in the segment's packed
``code << 4 | len`` tables.  Off-path positions get zero bits; ``v`` at
``n == 0`` is a don't-care value (the packer masks it away).

Replaces ``decompress_tpu/ops/pack_pl.py: build_slots_pl`` (its
``_slots_kernel``) with ``csrc/pack_slots.cu``.  The plain version is
the reference's XLA slot path (``de._get_pack_jit``).
"""

from __future__ import annotations

import torch

from ..core.tables import NUM_DIST_SYMS, NUM_LIT_SYMS

from .. import _build
from . import codes


def build_slots_plain(on_path, is_match, length, dist, sym_lit, lit_cb,
                      dist_cb):
    """(v01, n01, v23, n23) int32[B, T] by table gathers."""
    lcode, lex, lval = codes.length_code_parts(length)
    sym = torch.where(is_match, 257 + lcode, sym_lit.to(torch.int32))
    dsym, dex, dval = codes.dist_code_parts(dist)
    cb0 = torch.gather(lit_cb, 1, sym.to(torch.int64))
    n0 = torch.where(on_path, cb0 & 15, 0)
    v01 = (cb0 >> 4) | (lval << n0)
    n01 = n0 + torch.where(is_match, lex, 0)
    cb2 = torch.gather(dist_cb, 1, dsym.to(torch.int64))
    n2 = torch.where(is_match, cb2 & 15, 0)
    v23 = (cb2 >> 4) | (dval << n2)
    n23 = n2 + torch.where(is_match, dex, 0)
    return v01, n01, v23, n23


def build_slots(on_path, is_match, length, dist, sym_lit, lit_cb, dist_cb):
    """Slots of a batch: on_path/is_match bool[B, T], length/dist
    int32[B, T], sym_lit uint8[B, T] (payload bytes; rows may be a
    strided view), lit_cb int32[B, 286], dist_cb int32[B, 30].  A CPU
    tensor takes :func:`build_slots_plain`; a CUDA tensor launches the
    kernel (or raises).  Any batch size B."""
    if length.device.type == "cpu":
        return build_slots_plain(on_path, is_match, length, dist, sym_lit,
                                 lit_cb, dist_cb)
    b, t = length.shape
    for name, a, dt, shape in (("on_path", on_path, torch.bool, (b, t)),
                               ("is_match", is_match, torch.bool, (b, t)),
                               ("length", length, torch.int32, (b, t)),
                               ("dist", dist, torch.int32, (b, t)),
                               ("lit_cb", lit_cb, torch.int32, (b, NUM_LIT_SYMS)),
                               ("dist_cb", dist_cb, torch.int32, (b, NUM_DIST_SYMS))):
        _build.check_cuda(name, a, dt, shape)
    _build.check_rows("sym_lit", sym_lit, torch.uint8, (b, t))
    out = [torch.empty((b, t), dtype=torch.int32, device=length.device)
           for _ in range(4)]
    err = _build.lib().dtt_build_slots(
        on_path.data_ptr(), is_match.data_ptr(), length.data_ptr(),
        dist.data_ptr(), sym_lit.data_ptr(), sym_lit.stride(0),
        lit_cb.data_ptr(), dist_cb.data_ptr(), *(o.data_ptr() for o in out),
        b, t, _build.stream(length))
    _build.launched("build_slots", err)
    return tuple(out)
