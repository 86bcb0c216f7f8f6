"""Per-segment symbol histograms of the marked parse, on the card.

``hist_lit[b, s]`` counts the on-path positions of segment b whose symbol
is s (the literal byte, or 257 + length code for a match; EOB is not
counted) and ``hist_dist[b, c]`` the matches whose distance code is c.

Replaces ``decompress_tpu/ops/hist_pl.py: histograms_pl`` (its
``_hist_kernel``) with ``csrc/hist.cu``.  The plain version is the
reference's scatter-add form (``lz77._summarize_one``).
"""

from __future__ import annotations

import torch

from ..core.tables import NUM_DIST_SYMS, NUM_LIT_SYMS

from .. import _build
from . import codes


def histograms_plain(on_path, is_match, length, dist, lit):
    """(hist_lit int32[B, 286], hist_dist int32[B, 30]) by scatter-add."""
    b = length.shape[0]
    sym = torch.where(is_match, 257 + codes.length_code(length),
                      lit.to(torch.int32))
    hl = torch.zeros((b, NUM_LIT_SYMS), dtype=torch.int32, device=length.device)
    hl.scatter_add_(1, sym.to(torch.int64), on_path.to(torch.int32))
    hd = torch.zeros((b, NUM_DIST_SYMS), dtype=torch.int32, device=length.device)
    hd.scatter_add_(1, codes.dist_code(dist).to(torch.int64),
                    is_match.to(torch.int32))
    return hl, hd


def histograms(on_path, is_match, length, dist, lit):
    """Histograms of a batch: on_path/is_match bool[B, T], length/dist
    int32[B, T], lit uint8[B, T] (the payload bytes; rows may be a strided
    view).  A CPU tensor takes :func:`histograms_plain`; a CUDA tensor
    launches the kernel (or raises)."""
    if length.device.type == "cpu":
        return histograms_plain(on_path, is_match, length, dist, lit)
    b, t = length.shape
    for name, a, dt in (("on_path", on_path, torch.bool),
                        ("is_match", is_match, torch.bool),
                        ("length", length, torch.int32),
                        ("dist", dist, torch.int32)):
        _build.check_cuda(name, a, dt, (b, t))
    _build.check_rows("lit", lit, torch.uint8, (b, t))
    hl = torch.zeros((b, NUM_LIT_SYMS), dtype=torch.int32, device=length.device)
    hd = torch.zeros((b, NUM_DIST_SYMS), dtype=torch.int32, device=length.device)
    err = _build.lib().dtt_histograms(
        on_path.data_ptr(), is_match.data_ptr(), length.data_ptr(),
        dist.data_ptr(), lit.data_ptr(), lit.stride(0), hl.data_ptr(),
        hd.data_ptr(), b, t, _build.stream(length))
    _build.launched("histograms", err)
    return hl, hd
