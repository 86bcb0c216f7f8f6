"""Member-parallel inflate of the port's own archives: host member
parsing, and the plain-torch stages around the decode kernel.

Counterpart of ``decompress_tpu/ops/inflate.py`` for the bit-stride
(TB index) decode path:

* :func:`prepare_member` parses one member's DEFLATE block header on the
  host (code lengths, start bit) or resolves a stored member;
* the symbol decode itself is ``ops/inflate_cu.decode`` (the CUDA kernel);
* :func:`slot_counts_bits` sizes each decoded row, :func:`compact_commands`
  concatenates the rows' commands, and :func:`expand_commands` turns a
  member's commands into bytes by pointer jumping.

Commands are packed int32 words ``kind << 26 | dist << 10 | value``:
kind 0 literal (value = byte), 1 copy (value = length), 2 end.  The
reference's NOP slots (kind 3) belong to its TPU kernel's lockstep layout
and never occur here.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import de
from ..core import bitstream, huffman, tables

#: the end-of-block command, also the filler after a row's commands
END = 2 << 26


class NotParallelizable(ValueError):
    """Stream shape the device decoder doesn't cover (multi-block
    members etc.): callers take the serial route."""


def prepare_member(body: np.ndarray):
    """Host: parse one member's DEFLATE header; the body must be a
    single (final) fixed or dynamic block.  Returns ("huff",
    lit_lens int32[288], dist_lens int32[32], start_bit) or ("stored",
    bytes); raises NotParallelizable otherwise, de.MalformedError (or
    EOFError) on a malformed header."""
    r = bitstream.BitReader(body)
    bfinal = r.read(1)
    btype = r.read(2)
    if btype == 0:
        # stored member: a chain of stored chunks is pure byte slices
        out = bytearray()
        while True:
            r.align_to_byte()
            ln = int.from_bytes(r.read_bytes(2).tobytes(), "little")
            nlen = int.from_bytes(r.read_bytes(2).tobytes(), "little")
            if ln != (nlen ^ 0xFFFF):
                raise de.MalformedError("invalid complement of length")
            out += r.read_bytes(ln).tobytes()
            if bfinal:
                return ("stored", bytes(out))
            bfinal = r.read(1)
            if r.read(2) != 0:
                raise NotParallelizable("mixed block kinds in member")
    if not bfinal or btype not in (1, 2):
        raise NotParallelizable("not a single fixed/dynamic block")
    if btype == 1:
        lit_lens = tables.FIXED_LIT_LENGTHS
        dist_lens = tables.FIXED_DIST_LENGTHS
    else:
        lit_lens, dist_lens = de._parse_dynamic_lengths(r)
    # host-side validity checks (the device table build assumes sane trees)
    if huffman.kraft_slack(lit_lens) < 0 or huffman.kraft_slack(dist_lens) < 0:
        raise de.MalformedError("invalid dictionary")
    nd = int(np.sum(np.asarray(dist_lens) > 0))
    if huffman.kraft_slack(dist_lens) > 0 and nd > 1:
        raise de.MalformedError("invalid dictionary")
    if huffman.kraft_slack(lit_lens) > 0:
        raise de.MalformedError("invalid dictionary")
    ll = np.zeros(288, np.int32)
    ll[: np.asarray(lit_lens).size] = np.asarray(lit_lens, np.int32)
    dl = np.zeros(32, np.int32)
    dl[: np.asarray(dist_lens).size] = np.asarray(dist_lens, np.int32)
    start_bit = (r.pos * 8) - r.nbits
    return ("huff", ll, dl, start_bit)


def slot_counts_bits(kinds: torch.Tensor, stop_bits: torch.Tensor) -> torch.Tensor:
    """Command span of each bit-stopped row: interior rows (stop_bits > 0)
    end at their first end-filler slot, which is not part of the row;
    final rows include their end-of-block marker."""
    first_end = torch.argmax((kinds == 2).to(torch.int8), 1).to(torch.int32)
    return torch.where(stop_bits > 0, first_end, first_end + 1)


def compact_commands(packed: torch.Tensor, ncmds: torch.Tensor,
                     out_size: int) -> torch.Tensor:
    """Concatenate each row's first ``ncmds[b]`` commands of
    ``packed`` int32[B, S] into one flat int32[out_size] stream (gathers
    only); slots past the total hold the end filler."""
    b, m = packed.shape
    offsets = torch.cumsum(ncmds.to(torch.int64), 0)  # inclusive
    starts = offsets - ncmds
    j = torch.arange(out_size, device=packed.device)
    row = torch.clamp(torch.searchsorted(offsets, j, right=True), max=b - 1)
    idx = torch.clamp(j - starts[row], 0, m - 1)
    flat = packed[row, idx]
    return torch.where(j < offsets[-1], flat, END)


def expand_commands(kinds, values, dists, out_len: int, max_rounds: int | None = None):
    """LZ77 expansion, member-parallel: commands [B, S] -> (payload
    uint8[B, out_len], lengths int32[B]).

    Every output byte gets a source: a literal is its own root; a copy
    byte points at ``opos - dist + ((j - opos) % dist)`` (the modular
    form realises overlapping copies).  Pointer jumping resolves chains
    of copies in log(depth) rounds; each round's "anything changed" test
    is a host sync.  Output positions at or past out_len are dropped."""
    if max_rounds is None:
        # chains are < out_len deep; doubling needs log2 rounds
        max_rounds = max(4, out_len.bit_length() + 1)
    b, m = kinds.shape
    dev = kinds.device
    is_lit = kinds == 0
    is_copy = kinds == 1
    values = values.to(torch.int64)
    dists = dists.to(torch.int64)
    clen = torch.where(is_copy, values, torch.where(is_lit, 1, 0))
    opos = torch.cumsum(clen, 1) - clen  # output offset of each command
    total = opos[:, -1] + clen[:, -1]

    j = torch.arange(out_len, device=dev).expand(b, out_len)
    # literal scatter: value byte -> its output position (column out_len
    # collects what falls outside)
    lit_pos = torch.where(is_lit & (opos < out_len), opos, out_len)
    out_lit = torch.zeros((b, out_len + 1), dtype=torch.int64, device=dev)
    out_lit.scatter_add_(1, lit_pos, torch.where(is_lit, values, 0))
    # copy cover: each copy's command index at its start, then a running
    # max gives the covering copy of every position
    cmd = torch.arange(m, device=dev).expand(b, m)
    marker = torch.full((b, out_len + 1), -1, dtype=torch.int64, device=dev)
    marker.scatter_reduce_(1, torch.where(is_copy & (opos < out_len), opos, out_len),
                           torch.where(is_copy, cmd, -1), "amax")
    cov = torch.cummax(marker[:, :out_len], 1).values
    safe = torch.clamp(cov, min=0)
    c_opos = torch.gather(opos, 1, safe)
    c_len = torch.gather(clen, 1, safe)
    c_dist = torch.gather(dists, 1, safe)
    covered = ((cov >= 0) & (j < c_opos + c_len) & torch.gather(is_copy, 1, safe)
               & (j < total[:, None]))
    src = c_opos - c_dist + torch.remainder(j - c_opos, torch.clamp(c_dist, min=1))
    cur = torch.clamp(torch.where(covered, src, j), 0, out_len - 1)
    for _ in range(max_rounds):  # pointer jumping until literal-rooted
        nxt = torch.gather(cur, 1, cur)
        if torch.equal(nxt, cur):
            break
        cur = nxt
    out = torch.gather(out_lit, 1, cur).to(torch.uint8)
    return out, total.to(torch.int32)
