"""Mark path: the positions the greedy/lazy parse visits, on the card.

The parse walks a strictly increasing jump array ``g`` (``i < g[i] <= P``)
from position 0; ``on_path[i]`` is True iff the walk lands on ``i``.

Replaces ``decompress_tpu/ops/parse_pl.py: mark_path_pl`` (its
``_exit_kernel`` and ``_refine_kernel`` together with the XLA row-hop
scan between them) with ``csrc/mark_path.cu``: per-chunk doubling exits
(levels 1-5 by warp shuffles), one thread per segment hopping across the
chunks over a head table staged in shared memory by bulk copies, then a
top-down refinement.  The plain version here is the reference's
``lz77._mark_path``: full-domain pointer doubling, then a top-down entry
refinement.
"""

from __future__ import annotations

import torch

from .. import _build

#: positions per block of the CUDA kernel (log2); one thread per position
CHUNK_LOG = 10
#: exits per chunk in the kernel's head table (``kHeadW`` in csrc/mark_path.cu)
HEAD_W = 288


def mark_path_plain(g: torch.Tensor) -> torch.Tensor:
    """bool[B, P] of positions visited iterating g int[B, P] from 0
    (P a power of two): exit tables over 2^k blocks, then top-down entry
    values; P ("walked off the end") is a fixed point of every pass."""
    b, p = g.shape
    levels = p.bit_length() - 1
    idx = torch.arange(p, device=g.device)
    exits = [g.to(torch.int64)]
    for k in range(1, levels + 1):
        prev = exits[-1]
        end_k = ((idx >> k) + 1) << k
        stepped = torch.gather(prev, 1, torch.clamp(prev, max=p - 1))
        exits.append(torch.where(prev >= end_k, prev, stepped))
    # entry[i] = first walk value >= start of i's level-k block
    entry = torch.zeros(b, p, dtype=torch.int64, device=g.device)
    for k in range(levels - 1, -1, -1):
        blk = idx >> k
        is_right = (blk & 1) == 1
        mid = blk << k
        stepped = torch.gather(exits[k], 1, torch.clamp(entry, max=p - 1))
        entry = torch.where(is_right & (entry < mid), stepped, entry)
    return entry == idx


def mark_path(g: torch.Tensor) -> torch.Tensor:
    """on_path bool[B, P] for g int32[B, P], P a power of two.

    A CPU tensor takes :func:`mark_path_plain`; a CUDA tensor launches
    the kernel (or raises)."""
    if g.device.type == "cpu":
        return mark_path_plain(g)
    b, p = g.shape
    if p < 2 or p & (p - 1):
        raise ValueError(f"mark_path: P={p} must be a power of two >= 2")
    _build.check_cuda("g", g, torch.int32)
    chunk_log = min(CHUNK_LOG, p.bit_length() - 1)
    nchunks = p >> chunk_log
    # one scratch allocation: the head table first (its bulk copies need
    # 16-byte alignment), then the exits and the chunk entries
    scratch = torch.empty(b * (nchunks * HEAD_W + p + nchunks),
                          dtype=torch.int32, device=g.device)
    heads = scratch.data_ptr()
    exits = heads + 4 * b * nchunks * HEAD_W
    entries = exits + 4 * b * p
    on_path = torch.empty((b, p), dtype=torch.uint8, device=g.device)
    err = _build.lib().dtt_mark_path(
        g.data_ptr(), exits, heads, entries, on_path.data_ptr(), b, p,
        chunk_log, _build.stream(g))
    _build.launched("mark_path", err)
    return on_path.view(torch.bool)
