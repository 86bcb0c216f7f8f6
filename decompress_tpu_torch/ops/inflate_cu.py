"""DEFLATE symbol decode of split rows on the card.

A member of the port's archives is one fixed or dynamic block whose
symbol stream the compressor split at bit strides (``SPLIT_BITS``): row
k of a member decodes the commands that start in [start_k, stop_k),
where stop_k is the next row's start bit, and the member's final row
(stop 0) runs to the end-of-block symbol.  All rows decode at once.

* :func:`build_row_tables` builds each member's decode tables from its
  code lengths in plain torch: a 1024-entry root per alphabet, indexed by
  the first 10 stream bits, plus 32-slot subtables for longer codes.
  Entries are ``cls << 24 | nb << 20 | xtr << 16 | pay`` (cls 0 invalid,
  1 literal or distance, 2 length, 3 end of block, 4 subtable pointer;
  nb the full code length, xtr the extra-bit count, pay the literal,
  length base - 3, distance base - 1 or subtable offset), entry for entry
  the reference's ``ops/inflate_pl.build_row_tables``, built per member
  instead of per 128-lane row.
* :func:`decode` runs ``csrc/inflate.cu`` (one warp per row, its 32
  lanes decoding equal bit ranges of the row speculatively, then
  synchronised on Huffman codes' self-synchronisation; blocks of 8 rows of
  one member, the member's four tables staged in shared memory);
  :func:`decode_plain` is the serial loop over all rows at once in torch.
  Each row's commands land in its row of an int32[rows, max_cmds] output
  (``kind << 26 | dist << 10 | value``, then the end filler ``2 << 26``),
  with an ok flag and a command count per row.

Replaces ``decompress_tpu/ops/inflate_pl.py: _decode_pallas`` (its
``_decode_kernel``).  What existed only for the TPU's tiling is gone:
the 128-lane row grouping, the per-lane word slabs with their W-word
window and where-chain, NOP slots and output chunks; a row reads its
bits straight from its member's word row.

Stop semantics are the TPU kernel's: an interior row is done once its
cursor reaches its stop bit, an end-of-block inside an interior row is
malformed, the final row ends at end-of-block, and an invalid code or
distance code marks the row bad.  ``ok`` = done and not bad; a row that
does not finish within ``max_cmds`` commands is not ok.  Word reads are
clamped to the member's row, so a corrupt stream gives ``ok = False``
and never reads out of bounds.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..core import huffman, tables
from .inflate import END

ROOT_BITS = 10
ROOT_SIZE = 1 << ROOT_BITS
SUB_BITS = 15 - ROOT_BITS
SUB_SLOTS = 1 << SUB_BITS            # fixed 32-entry subtables
LITSUB_SIZE = 2048                   # 64 distinct long prefixes
DISTSUB_SIZE = 1024                  # 32 distinct long prefixes
ROW_WARPS = 8                        # rows per block of the decode kernel
MAX_ROW_BITS = (1 << 30) - 1         # the kernel keeps a row's bit positions in int32

CLS_INVALID = 0
CLS_LIT = 1
CLS_LEN = 2
CLS_EOB = 3
CLS_SUB = 4


def _entry(cls, nb, xtr, pay):
    return (cls << 24) | (nb << 20) | (xtr << 16) | pay


def _canonical_codes(lens: torch.Tensor) -> torch.Tensor:
    """MSB-first canonical code per symbol from code lengths int64[M, S]."""
    oneh = (lens[:, :, None] == torch.arange(1, 16, device=lens.device)).to(torch.int64)
    bl_count = oneh.sum(1)
    codes = []
    code = torch.zeros_like(bl_count[:, 0])
    for n in range(1, 16):
        codes.append(code)
        code = (code + bl_count[:, n - 1]) << 1
    first = torch.stack(codes, 1)
    rank = torch.cumsum(oneh, 1) - 1
    return (oneh * (first[:, None, :] + rank)).sum(2)


def _range_fill(size: int, start, length, entry, valid) -> torch.Tensor:
    """int64[M, size]: each slot holds the entry of the (start, length)
    range containing it, or 0.  Ranges starting at or past ``size`` are
    dropped.  A running max over (position << 32 | entry) at range starts
    and (end << 32) at range ends fills each range with its entry."""
    m = start.shape[0]
    idx = torch.where(valid, start, size).clamp(max=size)
    end = torch.where(valid, start + length, size).clamp(max=size)
    t = torch.zeros((m, size + 1), dtype=torch.int64, device=start.device)
    t.scatter_reduce_(1, idx, (idx << 32) | entry, "amax")
    t.scatter_reduce_(1, end, end << 32, "amax")
    return torch.cummax(t, 1).values[:, :size] & 0xFFFFFFFF


def _build_root_sub(lens: torch.Tensor, entry: torch.Tensor, sub_size: int):
    """Root and subtables of one alphabet for every member: lens and
    entry int64[M, S] -> (root int64[M, 1024], sub int64[M, sub_size],
    number of long-code prefixes int64[M])."""
    code = _canonical_codes(lens)
    valid = lens > 0
    short = valid & (lens <= ROOT_BITS)
    long_ = lens > ROOT_BITS

    # long-code prefixes -> dense subtable ranks
    big = 1 << 20
    pfx = torch.where(long_, code >> (lens - ROOT_BITS).clamp(min=0), big)
    sp = torch.sort(pfx, 1).values
    prev = torch.cat([torch.full_like(sp[:, :1], -1), sp[:, :-1]], 1)
    is_new = (sp != prev) & (sp < big)
    uniq = torch.sort(torch.where(is_new, sp, big), 1).values
    rank = torch.searchsorted(uniq, pfx)
    n_sub = is_new.sum(1)
    sub_base = rank * SUB_SLOTS

    # root: short codes own [code << (10-l), (code+1) << (10-l)); a
    # long-code prefix owns one slot holding the subtable pointer
    rshift = ROOT_BITS - lens.clamp(max=ROOT_BITS)
    r_start = torch.where(short, code << rshift, torch.where(long_, pfx, ROOT_SIZE))
    r_size = torch.where(short, 1 << rshift, torch.where(long_, 1, 0))
    r_entry = torch.where(short, entry,
                          _entry(CLS_SUB, ROOT_BITS, 0, 0) | sub_base.clamp(max=0xFFFF))
    root = _range_fill(ROOT_SIZE, r_start, r_size, r_entry, valid)

    # subtables: a long code's low l - 10 bits placed in its prefix's block
    low = torch.where(long_, code - (pfx << (lens - ROOT_BITS).clamp(min=0)), 0)
    s_start = sub_base + (low << (15 - lens.clamp(min=1)))
    s_size = 1 << (15 - lens.clamp(max=15))
    sub = _range_fill(sub_size, s_start, s_size, entry, long_)
    return root, sub, n_sub


def _lit_entries(lens: torch.Tensor) -> torch.Tensor:
    dev = lens.device
    lbase = torch.from_numpy(tables.LENGTH_BASE.astype(np.int64)).to(dev)
    lextra = torch.from_numpy(tables.LENGTH_EXTRA.astype(np.int64)).to(dev)
    sym = torch.arange(lens.shape[1], device=dev)
    is_lit = sym < 256
    is_eob = sym == 256
    lcode = (sym - 257).clamp(0, 28)
    cls = torch.where(is_lit, CLS_LIT, torch.where(is_eob, CLS_EOB, CLS_LEN))
    cls = torch.where(sym > 285, CLS_INVALID, cls)
    xtr = torch.where(sym > 256, lextra[lcode], 0)
    pay = torch.where(is_lit, sym, torch.where(is_eob, 0, lbase[lcode] - 3))
    e = _entry(cls, lens.clamp(max=15), xtr, pay)
    return torch.where((lens > 0) & (cls != CLS_INVALID), e, 0)


def _dist_entries(lens: torch.Tensor) -> torch.Tensor:
    dev = lens.device
    dbase = torch.from_numpy(tables.DIST_BASE.astype(np.int64)).to(dev)
    dextra = torch.from_numpy(tables.DIST_EXTRA.astype(np.int64)).to(dev)
    sym = torch.arange(lens.shape[1], device=dev)
    scode = sym.clamp(0, 29)
    e = _entry(CLS_LIT, lens.clamp(max=15), dextra[scode], dbase[scode] - 1)
    return torch.where((lens > 0) & (sym < 30), e, 0)


def build_row_tables(lit_lens: torch.Tensor, dist_lens: torch.Tensor):
    """Decode tables of every member: lit_lens int[M, 288], dist_lens
    int[M, 32] -> (lit_root int32[M, 1024], lit_sub [M, 2048], dist_root
    [M, 1024], dist_sub [M, 1024], ok bool[M]).  ``ok`` is False when a
    tree's long-code prefixes overflow the fixed subtable space (never
    for trees the compressor writes)."""
    ll = lit_lens.to(torch.int64)
    dl = dist_lens.to(torch.int64)
    lr, ls, ln = _build_root_sub(ll, _lit_entries(ll), LITSUB_SIZE)
    dr, ds, dn = _build_root_sub(dl, _dist_entries(dl), DISTSUB_SIZE)
    ok = (ln * SUB_SLOTS <= LITSUB_SIZE) & (dn * SUB_SLOTS <= DISTSUB_SIZE)
    return (*(t.to(torch.int32) for t in (lr, ls, dr, ds)), ok)


def tables_fit(lit_lens, dist_lens) -> bool:
    """Host: whether one member's trees fit the fixed subtable space,
    i.e. :func:`build_row_tables` gives it ``ok``.  Each distinct first
    10 bits of a code longer than 10 bits takes one 32-slot subtable."""
    for lens, size in ((lit_lens, LITSUB_SIZE), (dist_lens, DISTSUB_SIZE)):
        lens = np.asarray(lens)
        long_ = lens > ROOT_BITS
        # LSB-first codes: the first 10 stream bits are the low 10 bits
        prefixes = huffman.canonical_codes(lens)[long_] & (ROOT_SIZE - 1)
        if np.unique(prefixes).size * SUB_SLOTS > size:
            return False
    return True


def stage(bodies, lit_lens, dist_lens, row_bits, device):
    """Card inputs of a decode: member bodies (uint8 arrays), their code
    lengths, and per member the (start, stop) bits of its rows, in order.
    Returns a dict: ``words`` int32[M, W] (each body's little-endian
    words, zero-padded by at least one word), ``tabs`` (the four tables),
    ``tab_ok`` bool[M], ``row_ptr`` int32[M + 1] (member m's rows are
    row_ptr[m]..row_ptr[m + 1]), ``start``/``stop`` int32[R], ``nbits``
    int32[M] (each body's bit length, where a final row's lane ranges
    end) and ``blocks`` int32[NB, 2] (member, first row) of each
    ``ROW_WARPS``-row block of the kernel's grid, rows of one member.
    Raises ValueError for a row that spans more than ``MAX_ROW_BITS``
    (to its stop, or to its body's end for a final row)."""
    m = len(bodies)
    nw = max(b.size for b in bodies) // 4 + 2
    words = np.zeros((m, nw * 4), np.uint8)
    for i, body in enumerate(bodies):
        words[i, : body.size] = body
    counts = [len(r) for r in row_bits]
    bits = np.array([b for r in row_bits for b in r], np.int32).reshape(-1, 2)
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    ends = np.repeat([b.size * 8 for b in bodies], counts)
    span = np.where(bits[:, 1] > 0, bits[:, 1], ends) - bits[:, 0].astype(np.int64)
    if span.size and span.max() > MAX_ROW_BITS:
        raise ValueError(f"a decode row spans {span.max()} bits, above {MAX_ROW_BITS}")
    blocks = np.array([(i, row_ptr[i] + j) for i, c in enumerate(counts)
                       for j in range(0, c, ROW_WARPS)], np.int32).reshape(-1, 2)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    *tabs, tab_ok = build_row_tables(put(np.asarray(lit_lens, np.int32)),
                                     put(np.asarray(dist_lens, np.int32)))
    return {"words": put(words.view("<i4")), "tabs": tuple(tabs), "tab_ok": tab_ok,
            "row_ptr": put(row_ptr), "start": put(bits[:, 0]), "stop": put(bits[:, 1]),
            "nbits": put(np.array([b.size * 8 for b in bodies], np.int32)),
            "blocks": put(blocks)}


def _rev15(x: torch.Tensor) -> torch.Tensor:
    """Reverse the low 15 bits (int64)."""
    x = x & 0x7FFF
    x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555)
    x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333)
    x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F)
    x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF)
    return x >> 1


def decode_plain(words, tabs, row_ptr, start, stop, nbits, blocks, max_cmds: int):
    """Every row's decode at once in torch, one command per step (the
    serial loop; ``nbits`` and ``blocks``, which only shape the kernel's
    lanes and grid, are not read).  Returns (cmds int32[R, max_cmds], ok
    bool[R], ncmds int32[R])."""
    dev = words.device
    m, nw = words.shape
    r = start.shape[0]
    member = torch.repeat_interleave(
        torch.arange(m, device=dev), torch.diff(row_ptr.to(torch.int64)), output_size=r)
    wflat = words.reshape(-1).to(torch.int64) & 0xFFFFFFFF
    lr, ls, dr, ds = (t.reshape(-1).to(torch.int64) for t in tabs)

    def peek32(o):
        wi = o >> 5
        w0 = wflat[member * nw + wi.clamp(0, nw - 1)]
        w1 = wflat[member * nw + (wi + 1).clamp(0, nw - 1)]
        return ((w0 | (w1 << 32)) >> (o & 31)) & 0xFFFFFFFF

    def lookup(root, sub, sub_size, idx15):
        e = root[member * ROOT_SIZE + (idx15 >> SUB_BITS)]
        sidx = ((e & 0xFFFF) + (idx15 & (SUB_SLOTS - 1))).clamp(max=sub_size - 1)
        return torch.where((e >> 24) == CLS_SUB, sub[member * sub_size + sidx], e)

    o = start.to(torch.int64)
    stop = stop.to(torch.int64)
    interior = stop > 0
    done = torch.zeros(r, dtype=torch.bool, device=dev)
    bad = torch.zeros_like(done)
    nreal = torch.zeros(r, dtype=torch.int32, device=dev)
    cmds = torch.full((r, max_cmds), END, dtype=torch.int32, device=dev)
    for s in range(max_cmds):
        done |= interior & (o >= stop)
        peek = peek32(o)
        e = lookup(lr, ls, LITSUB_SIZE, _rev15(peek))
        cls, nb, xtr, pay = e >> 24, (e >> 20) & 15, (e >> 16) & 15, e & 0xFFFF
        is_len = cls == CLS_LEN
        is_eob = cls == CLS_EOB
        value = torch.where(is_len, pay + 3 + ((peek >> nb) & ((1 << xtr) - 1)), pay)
        c1 = nb + xtr
        peek2 = peek32(o + c1)
        d = lookup(dr, ds, DISTSUB_SIZE, _rev15(peek2))
        dnb, dxn = (d >> 20) & 15, (d >> 16) & 15
        dist = (d & 0xFFFF) + 1 + ((peek2 >> dnb) & ((1 << dxn) - 1))
        sym_bad = (cls == CLS_INVALID) | (is_len & ((d >> 24) == CLS_INVALID))
        sym_bad |= ~done & ~sym_bad & is_eob & interior
        write = ~done & ~sym_bad
        okind = torch.where(is_eob, 2, torch.where(is_len, 1, 0))
        packed = (okind << 26) | (torch.where(is_len, dist, 0) << 10) | value
        cmds[:, s] = torch.where(write, packed, END).to(torch.int32)
        bad |= ~done & sym_bad
        o += torch.where(write, torch.where(is_eob, c1, c1 + torch.where(is_len, dnb + dxn, 0)), 0)
        nreal += write.to(torch.int32)
        done |= (write & is_eob) | bad
        if s % 64 == 63 and bool(done.all()):
            break
    ok = (done | (interior & (o >= stop))) & ~bad
    return cmds, ok, nreal


def decode(words, tabs, row_ptr, start, stop, nbits, blocks, max_cmds: int, rounds=None):
    """Decode every split row: ``words`` int32[M, W] member word rows,
    ``tabs`` the four tables of :func:`build_row_tables` (int32, M rows
    each), ``row_ptr`` int32[M + 1], ``start``/``stop`` int32[R] bits,
    ``nbits`` int32[M] and ``blocks`` int32[NB, 2] as :func:`stage` gives
    them (every row spanning at most ``MAX_ROW_BITS``).  Returns (cmds int32[R, max_cmds], ok bool[R], ncmds int32[R]).
    A CPU tensor takes :func:`decode_plain`; a CUDA tensor launches the
    kernel (or raises), which also writes each row's synchronisation
    rounds into ``rounds`` (int32[R]) where one is given."""
    if words.device.type == "cpu":
        return decode_plain(words, tabs, row_ptr, start, stop, nbits, blocks, max_cmds)
    m, nw = words.shape
    r = start.shape[0]
    _build.check_cuda("words", words, torch.int32, (m, nw))
    for name, t, size in zip(("lit_root", "lit_sub", "dist_root", "dist_sub"), tabs,
                             (ROOT_SIZE, LITSUB_SIZE, ROOT_SIZE, DISTSUB_SIZE)):
        _build.check_cuda(name, t, torch.int32, (m, size))
    _build.check_cuda("row_ptr", row_ptr, torch.int32, (m + 1,))
    _build.check_cuda("start", start, torch.int32, (r,))
    _build.check_cuda("stop", stop, torch.int32, (r,))
    _build.check_cuda("nbits", nbits, torch.int32, (m,))
    _build.check_cuda("blocks", blocks, torch.int32, (blocks.shape[0], 2))
    if rounds is not None:
        _build.check_cuda("rounds", rounds, torch.int32, (r,))
    cmds = torch.empty((r, max_cmds), dtype=torch.int32, device=words.device)
    ok = torch.empty(r, dtype=torch.bool, device=words.device)
    ncmds = torch.empty(r, dtype=torch.int32, device=words.device)
    err = _build.lib().dtt_inflate_rows(
        words.data_ptr(), nw, *(t.data_ptr() for t in tabs), row_ptr.data_ptr(),
        start.data_ptr(), stop.data_ptr(), nbits.data_ptr(), blocks.data_ptr(),
        blocks.shape[0], cmds.data_ptr(), ok.data_ptr(), ncmds.data_ptr(),
        None if rounds is None else rounds.data_ptr(), max_cmds, _build.stream(words))
    _build.launched("decode", err)
    return cmds, ok, ncmds
