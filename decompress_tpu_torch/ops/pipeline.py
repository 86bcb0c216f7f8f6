"""The whole fixed-Huffman DEFLATE step on the device (torch).

Counterpart of ``decompress_tpu/ops/pipeline.py``:
:func:`fixed_deflate_segments` runs match finding, the parse and the
entropy emission of a batch of segments on their device with the fixed
Huffman trees (RFC 1951 §3.2.6), with no host tree build and no host
sync: exact candidates, the mark-path and histogram kernels
(``lz77.lz77_analyze(force_exact=True)``), the fixed-code arithmetic of
``ops/codes``, then :func:`bitpack.pack_bits_device`, captured as one
program (``ops/graphs``) on a CUDA device.  The dynamic-tree
pipeline (``de.deflate``) adds a host tree build between the same two
device stages.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import huffman, tables
from . import bitpack, codes, graphs, lz77


@functools.cache
def _fixed_code_arrays():
    lit_len = tables.FIXED_LIT_LENGTHS
    dist_len = tables.FIXED_DIST_LENGTHS
    lit_code = huffman.canonical_codes(lit_len)
    dist_code = huffman.canonical_codes(dist_len)
    return (
        lit_code[: tables.NUM_LIT_SYMS].astype(np.uint32),
        lit_len[: tables.NUM_LIT_SYMS].astype(np.int32),
        dist_code[: tables.NUM_DIST_SYMS].astype(np.uint32),
        dist_len[: tables.NUM_DIST_SYMS].astype(np.int32),
    )


@functools.cache
def _fixed_tables(dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The packed (code << 4 | len) fixed tables on ``dev``, int64[286] and
    int64[30]: made once a device, before any capture (a copy from host
    memory cannot be captured)."""
    lit_code, lit_len, dist_code, dist_len = _fixed_code_arrays()
    return tuple(torch.from_numpy((c.astype(np.int64) << 4) | n).to(dev)
                 for c, n in ((lit_code, lit_len), (dist_code, dist_len)))


def fixed_deflate_segments(data, n_valid, hist_len, bfinal, *, level: int = 6,
                           seg_len: int = 1 << 17, out_words: int | None = None):
    """Whole fixed-Huffman DEFLATE blocks, one a segment, on the device of
    ``data``.

    data: uint8[B, HIST + seg_len] (32 KiB history prefix, then the
    payload, zero padded); n_valid, hist_len: int32[B] payload and valid
    history bytes; bfinal: int32[B], 1 where the segment ends its stream.
    Returns (words uint32[B, out_words], total_bits int32[B]): standard
    single-block fixed-Huffman DEFLATE bodies, LSB-first in little-endian
    words, equal to the reference's.  The device work is one program
    (:func:`fixed_step`)."""
    if out_words is None:
        out_words = (10 * seg_len) // 32 + 64
    lit_cb, dist_cb = _fixed_tables(data.device)
    return fixed_step(data, n_valid, hist_len, bfinal, lit_cb, dist_cb, level=level,
                      seg_len=seg_len, out_words=out_words)


@graphs.program(static=("level", "seg_len", "out_words"))
def fixed_step(data, n_valid, hist_len, bfinal, lit_cb, dist_cb, *, level: int,
               seg_len: int, out_words: int):
    """The fixed step's device work (the reference's jitted
    ``fixed_deflate_segments``) over the packed fixed tables of
    :func:`_fixed_tables`."""
    # exact extension: one device pass with no verification retry, so the
    # output is correct without a host sync
    res = lz77.lz77_analyze(data, n_valid, hist_len, level=level,
                            seg_len=seg_len, force_exact=True)
    lit_code, lit_len, _, _ = _fixed_code_arrays()
    dev = data.device

    on_path, is_match = res["on_path"], res["is_match"]
    sym_lit = data[:, lz77.HIST:].to(torch.int64)

    lcode, lex, lval = codes.length_code_parts(res["length"])
    sym = torch.where(is_match, 257 + lcode.to(torch.int64), sym_lit)
    dsym, dex, dval = codes.dist_code_parts(res["dist"])
    cb0 = lit_cb[sym]
    v0 = cb0 >> 4
    n0 = torch.where(on_path, cb0 & 15, 0)
    v1 = lval.to(torch.int64)
    n1 = torch.where(is_match, lex.to(torch.int64), 0)
    cb2 = dist_cb[dsym.to(torch.int64)]
    v2 = cb2 >> 4
    n2 = torch.where(is_match, cb2 & 15, 0)
    v3 = dval.to(torch.int64)
    n3 = torch.where(is_match, dex.to(torch.int64), 0)
    v01 = v0 | (v1 << n0)
    v23 = v2 | (v3 << n2)

    b = data.shape[0]
    vals = torch.stack([v01, v23], 2).reshape(b, -1)
    nbs = torch.stack([n0 + n1, n2 + n3], 2).reshape(b, -1)

    # header (BFINAL, BTYPE=01) and the trailing EOB
    hdr_vals = torch.stack([bfinal.to(torch.int64), torch.ones_like(bfinal, dtype=torch.int64)], 1)
    hdr_bits = torch.arange(1, 3, dtype=torch.int64, device=dev).expand(b, 2)
    eob_vals = torch.full((b, 1), int(lit_code[tables.EOB]), dtype=torch.int64, device=dev)
    eob_bits = torch.full((b, 1), int(lit_len[tables.EOB]), dtype=torch.int64, device=dev)

    all_vals = torch.cat([hdr_vals, vals, eob_vals], 1)
    all_nbs = torch.cat([hdr_bits, nbs, eob_bits], 1)
    return bitpack.pack_bits_device(all_vals, all_nbs, out_words)
