"""A CPU model of the decode kernel's warp-per-row design == the serial
decode (``inflate_cu.decode_plain``), on the CPU.

``csrc/inflate.cu`` splits each split row into 32 lane ranges of L =
ceil(span / 32) bits (span: to stop for an interior row, to the body's
bit length for the final row; a row with span <= 0 runs on lane 0),
decodes each range speculatively from where a walk from 256 bits before
it first lands in it, synchronises lane
k on lane k - 1's exit until no live lane changes (a lane after the
first lane that ended is dead), lets the final row's last lane go on
unbounded where the exact decode reached the body's end without an
end-of-block, then scans the counts into output offsets and decodes a
third time to write.  The model
below follows the same lane ranges and rules, lanes as a tensor axis and
rows vectorised in torch, with ``decode_plain``'s peek and table-lookup
arithmetic, so the synchronisation logic is checked without the card:
its (cmds, ok, ncmds) must equal ``decode_plain``'s exactly on archive
rows, a fixed-Huffman member, a flipped end-of-block, flipped bits inside
interior rows, truncation at ``max_cmds``, rows of 1–100 bits and rows
starting before and past the body, and every row must converge in at
most 32 rounds.
"""

import pathlib
import zlib

import numpy as np
import pytest
import torch

from decompress_tpu_torch.ops import inflate, inflate_cu
from decompress_tpu_torch.parallel import sharded

CORPUS = pathlib.Path(__file__).parent / "corpus"
LANES = 32
WARM_BITS = 256  # bits a lane decodes before its range, uncounted
UNBOUNDED = 1 << 62
RAN, EOB, BAD, FULL = 0, 1, 2, 3  # how a lane's walk ended


class _Member:
    """The decode inputs of one walker batch, gathered per walker."""

    def __init__(self, st):
        self.nw = st["words"].shape[1]
        self.wflat = st["words"].reshape(-1).to(torch.int64) & 0xFFFFFFFF
        self.tabs = [t.reshape(-1).to(torch.int64) for t in st["tabs"]]

    def peek32(self, member, o):
        wi = o >> 5
        w0 = self.wflat[member * self.nw + wi.clamp(0, self.nw - 1)]
        w1 = self.wflat[member * self.nw + (wi + 1).clamp(0, self.nw - 1)]
        return ((w0 | (w1 << 32)) >> (o & 31)) & 0xFFFFFFFF

    @staticmethod
    def lookup(member, root, sub, sub_size, idx15):
        e = root[member * inflate_cu.ROOT_SIZE + (idx15 >> inflate_cu.SUB_BITS)]
        sidx = ((e & 0xFFFF) + (idx15 & (inflate_cu.SUB_SLOTS - 1))).clamp(max=sub_size - 1)
        return torch.where((e >> 24) == inflate_cu.CLS_SUB, sub[member * sub_size + sidx], e)

    def walk(self, member, o, hi, interior, cap, out=None, row=None, off=None):
        """Every walker at once: decode the commands that start in [o, hi),
        at most cap of them -> (exit bit, count, how it ended); with
        ``out``, command i of walker j goes to out[row[j], off[j] + i]."""
        lr, ls, dr, ds = self.tabs
        o = o.clone()
        n = torch.zeros_like(o)
        end = torch.full_like(o, RAN)
        live = o < hi
        while bool(live.any()):
            full = live & (n == cap)
            end[full] = FULL
            live &= ~full
            peek = self.peek32(member, o)
            e = self.lookup(member, lr, ls, inflate_cu.LITSUB_SIZE, inflate_cu._rev15(peek))
            cls, nb, xtr, pay = e >> 24, (e >> 20) & 15, (e >> 16) & 15, e & 0xFFFF
            is_len = cls == inflate_cu.CLS_LEN
            is_eob = cls == inflate_cu.CLS_EOB
            c1 = nb + xtr
            peek2 = self.peek32(member, o + c1)
            d = self.lookup(member, dr, ds, inflate_cu.DISTSUB_SIZE, inflate_cu._rev15(peek2))
            dnb, dxn = (d >> 20) & 15, (d >> 16) & 15
            bad = live & ((cls == inflate_cu.CLS_INVALID)
                          | (is_len & ((d >> 24) == inflate_cu.CLS_INVALID))
                          | (is_eob & interior))
            end[bad] = BAD
            live &= ~bad
            value = torch.where(is_len, pay + 3 + ((peek >> nb) & ((1 << xtr) - 1)), pay)
            dist = (d & 0xFFFF) + 1 + ((peek2 >> dnb) & ((1 << dxn) - 1))
            kind = torch.where(is_eob, 2, torch.where(is_len, 1, 0))
            cmd = (kind << 26) | (torch.where(is_len, dist, 0) << 10) | value
            if out is not None:
                out[row[live], (off + n)[live]] = cmd[live].to(torch.int32)
            o = torch.where(live, o + c1 + torch.where(is_len, dnb + dxn, 0), o)
            n += live.to(n.dtype)
            eob = live & is_eob
            end[eob] = EOB
            live &= ~eob & (o < hi)
        return o, n, end


def split_decode(st, max_cmds):
    """The kernel's three phases over every row -> (cmds, ok, ncmds,
    rounds): the serial decode's outputs and each row's synchronisation
    rounds (passes in which some lane decoded again)."""
    mem = _Member(st)
    row_ptr = st["row_ptr"].to(torch.int64)
    start = st["start"].to(torch.int64)
    stop = st["stop"].to(torch.int64)
    r = start.shape[0]
    member = torch.repeat_interleave(torch.arange(row_ptr.numel() - 1), torch.diff(row_ptr),
                                     output_size=r)
    interior = stop > 0
    span = torch.where(interior, stop, st["nbits"].to(torch.int64)[member]) - start
    covered = span.clamp(min=0)
    lsize = (covered + LANES - 1) // LANES
    last = torch.where(span > 0, LANES - 1, 0)
    lane = torch.arange(LANES)[None, :]
    lo = start[:, None] + torch.minimum(lane * lsize[:, None], covered[:, None])
    hi = torch.where(lane == last[:, None], (start + torch.where(interior, span, covered))[:, None],
                     start[:, None] + torch.minimum((lane + 1) * lsize[:, None],
                                                    covered[:, None]))
    mem_l = member[:, None].expand(r, LANES)
    int_l = interior[:, None].expand(r, LANES)

    def walk(sel, s, **kw):
        return mem.walk(mem_l[sel], s[sel], hi[sel], int_l[sel], max_cmds, **kw)

    # 1. speculate, from where a walk from WARM_BITS before lo first lands
    # at or past lo (lo if that walk ends early)
    s = lo.clone()
    warm = (lane > 0) & (lane <= last[:, None])
    wo, _, wend = mem.walk(mem_l[warm], torch.maximum(start[:, None], lo - WARM_BITS)[warm],
                           lo[warm], int_l[warm], max_cmds)
    s[warm] = torch.where(wend == RAN, wo, lo[warm])
    o, n, end = (t.reshape(r, LANES) for t in mem.walk(
        mem_l.reshape(-1), s.reshape(-1), hi.reshape(-1), int_l.reshape(-1), max_cmds))
    # 2. synchronise
    rounds = torch.zeros(r, dtype=torch.int64)
    for _ in range(LANES + 1):
        prev = torch.cat([o[:, :1], o[:, :-1]], 1)
        ended = (end != RAN).to(torch.int64)
        dead = (torch.cumsum(ended, 1) - ended) > 0
        redo = (lane > 0) & ~dead & (prev != s)
        if not bool(redo.any()):
            break
        rounds += redo.any(1).to(torch.int64)
        s = torch.where(redo, prev, s)
        o[redo], n[redo], end[redo] = walk(redo, s)
    else:
        raise AssertionError("a row did not converge")
    # the final row ran to the body's end: its last lane goes on unbounded
    tail = ~interior & (end == RAN).all(1)
    at = tail[:, None] & (lane == last[:, None])
    o2, n2, end[at] = mem.walk(mem_l[at], o[at], torch.full_like(o[at], UNBOUNDED),
                               int_l[at], max_cmds - n[at])
    o[at], n[at] = o2, n[at] + n2
    # 3. write
    hi = torch.where(~interior[:, None] & (lane == last[:, None]), UNBOUNDED, hi)
    cnt = torch.where(dead, 0, n)
    incl = torch.cumsum(cnt, 1)
    off = incl - cnt
    total = incl[:, -1]
    ended = end != RAN
    first = torch.where(ended.any(1), ended.to(torch.int64).argmax(1), 0)
    how = end.gather(1, first[:, None])[:, 0]
    good = (total <= max_cmds) & torch.where(ended.any(1), how == EOB, interior)
    cmds = torch.full((r, max_cmds), inflate.END, dtype=torch.int32)
    sel = (cnt > 0) & (off < max_cmds)
    rows = torch.arange(r)[:, None].expand(r, LANES)
    cap = torch.minimum(cnt, max_cmds - off)
    mem.walk(mem_l[sel], s[sel], hi[sel], int_l[sel], cap[sel], out=cmds, row=rows[sel],
             off=off[sel])
    return cmds, good, total.clamp(max=max_cmds).to(torch.int32), rounds


def _check(st, max_cmds):
    """The model == decode_plain on every row; returns the model's rounds."""
    args = (st["words"], st["tabs"], st["row_ptr"], st["start"], st["stop"], st["nbits"],
            st["blocks"], max_cmds)
    want = inflate_cu.decode_plain(*args)
    *got, rounds = split_decode(st, max_cmds)
    for name, g, w in zip(("cmds", "ok", "ncmds"), got, want):
        assert torch.equal(g, w), name
    assert int(rounds.max()) <= LANES
    return want, rounds


def _archive(payload, member_size, split_bits, monkeypatch):
    """Decode plan of the port's level-6 sharded archive of payload."""
    monkeypatch.setattr(sharded, "SPLIT_BITS", split_bits)
    buf = np.frombuffer(sharded.sharded_gzip_compress(payload, 6, member_size=member_size,
                                                      device="cpu"), np.uint8)
    return sharded.decode_plan(buf)


def _stage(metas, huff, rows, bodies=None):
    bodies = bodies or [metas[i][1] for i in huff]
    return inflate_cu.stage(bodies, [metas[i][0][1] for i in huff],
                            [metas[i][0][2] for i in huff], rows, "cpu")


@pytest.fixture(scope="module")
def archives():
    """The archive of ``tests/test_torch_inflate.py`` (members of 2,048
    bytes, splits every 1,024 bits) and one of the book1 text in members
    of 4,096 bytes at the production split stride (8,192 bits)."""
    rng = np.random.default_rng(5)
    payload = (b"the decode kernel must agree with the reference's " * 120
               + rng.integers(0, 256, 3000, np.uint8).tobytes() + b"\x00" * 3000)
    book = (CORPUS / "book1").read_bytes()[:16384]
    with pytest.MonkeyPatch.context() as mp:
        return {"short_rows": _archive(payload, 2048, 1024, mp),
                "production_rows": _archive(book, 4096, 8192, mp)}


@pytest.mark.parametrize("name", ["short_rows", "production_rows"])
def test_split_model_on_archive_rows(archives, name):
    metas, huff, rows, max_cmds = archives[name]
    (_, ok, _), rounds = _check(_stage(metas, huff, rows), max_cmds)
    assert ok.all() and len(rows[0]) >= 1
    assert int(rounds.max()) >= 1  # lanes started off the codeword boundaries


def _flip(body, bits):
    body = body.copy()
    for b in bits:
        body[b >> 3] ^= 1 << (b & 7)
    return body


@pytest.mark.parametrize("name", ["short_rows", "production_rows"])
def test_split_model_flipped_end_of_block(archives, name):
    """The first member's end-of-block flipped: its final row decodes on
    into the zero padding and the clamped words, ending at max_cmds."""
    metas, huff, rows, max_cmds = archives[name]
    body = metas[huff[0]][1].copy()
    body[-1] ^= 1 << 7 if body[-1] >> 7 else 1
    bodies = [body] + [metas[i][1] for i in huff[1:]]
    (_, ok, _), _ = _check(_stage(metas, huff, rows, bodies), max_cmds)
    assert (~ok).nonzero().flatten().tolist() == [len(rows[0]) - 1]


def test_split_model_flipped_interior_bits(archives):
    """Bits flipped inside interior rows: speculative lanes and the exact
    decode meet invalid codes, bad distances and shifted boundaries."""
    metas, huff, rows, max_cmds = archives["production_rows"]
    rng = np.random.default_rng(11)
    bodies = []
    for k, i in enumerate(huff):
        (s0, s1), = rows[k][:1]
        bodies.append(_flip(metas[i][1], rng.integers(s0, s1, 40 + k)))
    (_, ok, _), _ = _check(_stage(metas, huff, rows, bodies), max_cmds)
    assert not ok.all()


def test_split_model_truncation_at_max_cmds(archives):
    """max_cmds one below, at and one above a row's true command count."""
    metas, huff, rows, max_cmds = archives["production_rows"]
    st = _stage(metas, huff, rows)
    (_, _, ncmds), _ = _check(st, max_cmds)
    for row in (0, int(st["row_ptr"][1]) - 1):  # an interior row and a final row
        c = int(ncmds[row])
        for cap in (c - 1, c, c + 1):
            (_, ok, got), _ = _check(st, cap)
            assert bool(ok[row]) == (cap >= c) and int(got[row]) == min(c, cap)


def test_split_model_short_rows(archives):
    """Rows of 1–100 bits (lane ranges under the 48 bits of the longest
    command, so long commands jump whole ranges), from codeword starts and
    from arbitrary bits."""
    metas, huff, rows, _ = archives["production_rows"]
    s0 = rows[0][1][0]
    lens = [1, 2, 5, 31, 32, 33, 47, 48, 63, 64, 65, 100]
    pairs = [(s0, s0 + n) for n in lens] + [(s0 + 7, s0 + 7 + n) for n in lens]
    st = _stage(metas, huff[:1], [pairs])
    _check(st, 64)
    _check(st, 3)


def test_split_model_fixed_member():
    x = (CORPUS / "paper1").read_bytes()[:3000]
    c = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)
    body = np.frombuffer(c.compress(x) + c.flush(), np.uint8)
    _, ll, dl, start = inflate.prepare_member(body)
    rows = [(start, start + 4000), (start + 4000, start + 9000), (start + 9000, 0)]
    _check(inflate_cu.stage([body], [ll], [dl], [rows], "cpu"), len(x) + 2)
    st = inflate_cu.stage([body], [ll], [dl], [[(start, 0)]], "cpu")
    (_, ok, ncmds), _ = _check(st, len(x) + 2)
    assert ok.all() and int(ncmds[0]) <= len(x) + 1


def test_split_model_rows_outside_the_body():
    """Rows starting before the body and far past it read only clamped
    words; so do interior rows there."""
    x = (CORPUS / "paper1").read_bytes()[:3000]
    c = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)
    body = np.frombuffer(c.compress(x) + c.flush(), np.uint8)
    _, ll, dl, _ = inflate.prepare_member(body)
    past = body.size * 8 + 4096
    st = inflate_cu.stage([body, body, body], [ll] * 3, [dl] * 3,
                          [[(-40, 0)], [(past, 0)], [(-40, 300), (past, past + 500),
                                                     (past + 10, past + 5)]], "cpu")
    _check(st, 64)
