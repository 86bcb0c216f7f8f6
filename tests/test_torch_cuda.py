"""CUDA kernels == their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
False (decided inside the fixture, so every worker collects the same
tests).  This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Random and extreme inputs, odd shapes (P below one 1024-position chunk
and P = 2^18, jumps past the mark path's staged head table, batches of 1
and 9 rows, T = 1 and T off the literal-bits tile and off 16 positions,
strided payload rows aligned and not, one symbol at every position,
nothing on the path, matches running into the row end, with and without
the hot lane); exact equality (integer kernels), slot values compared
under their n-bit masks; gzip on the card at levels 1, 4, 6 and 9 equal
to the CPU port.  The decode kernel against its plain version on archive
rows (dynamic, stored, zero-run and fixed members, a flipped end-of-block,
flipped bits inside interior rows, max_cmds around a row's count, rows of
1-100 bits, rows outside the body), the CRC kernel on rows of lengths
around its 16-byte pieces with init values and junk past each length,
and the sharded round trip on the card.  zlib framing on the card
(``zl.deflate`` at levels 1, 6 and 9 with a dictionary and a small window,
and ``sharded_zlib_compress``) equal to the CPU port, and Adler-32 on the
card equal to ``zlib.adler32``.  The streaming encoders on the card
(``gz.Def`` on the segment engine, ``zl.Def`` and ``gz.Def`` on the queue
engine, ``match_commands_batch`` on ragged chunk rows) equal to the same
calls on the CPU.  LZO compression (its mark-path and histogram
launches counted), the fixed-Huffman step (B = 2, 8 and 3, with history;
each row decoded by zlib), ``compress_step_sharded`` on ``make_mesh()`` and
on one card twice, and a mesh archive on both, equal to the CPU port.
The schedules: the level-6 gzip of the 8 MiB corpus at PIPELINE_DEPTH 4
and 1 against the reference's digest; every host read of the pipelined
and windowed writers, as received, equal to a blocking re-read; both
writers under ``torch.cuda.set_sync_debug_mode("error")``; both
``expand`` routes of the sharded decode, with their launches, and a
flipped CRC-32 taking the counted serial route (the reference's error) on
each.  The 8 MiB corpus's archives with the legacy TS index and with the
index cut to member sizes decoded on the card on both routes in one
launch, in 9 launches with the group bound lowered, and the decode kernel
on whole-member rows against its plain version.  The captured programs
(``ops/graphs``) at the main paths' shapes (``chip_smoke.program_cases``):
every replay equal to its eager function, exactly; a replay of other
inputs leaving an earlier result as it was; each replay adding its
capture's launches; two threads, each on its own stream, replaying one
round-A key on different inputs; a capture that syncs raising every
time; the LRU evicting and capturing again.  Round A's candidate search
(fields, probe, extend) on the arguments round A gives it
(``chip_smoke.ROUND_A_CASES``) and on short rows of 150, 4,097 and
4,999 bytes (text, one repeated byte, random) with and without history.
The port's tracing (``utils.profiling``): a kernel launched and
synchronized inside a span lies inside it on the profiler's clock; the
gzip and archive writers traced under the sync debug mode "error"; the
spans and counters of the card's paths.
"""

import collections
import dataclasses
import functools
import gzip
import hashlib
import pathlib
import threading
import time
import zlib

import numpy as np
import pytest
import torch

import chip_smoke
from decompress_tpu_torch import _build, de, gz, lzo, parallel, zl
from decompress_tpu_torch.ops import (bitpack, checksum, cost_cu, crc_cu, graphs, hist_cu,
                                      inflate, inflate_cu, lz77, pack_cu, parse_cu,
                                      pipeline, probe_cu, transfer)
from decompress_tpu_torch.parallel import sharded
from torch_archives import sizes_only

pytestmark = pytest.mark.cuda
CORPUS = pathlib.Path(__file__).parent / "corpus"


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _jumps(rng, b, p, seg_len, take_p=0.3):
    step = np.ones((b, p), np.int64)
    take = rng.random((b, seg_len)) < take_p
    step[:, :seg_len] = np.where(take, rng.integers(3, 259, (b, seg_len)), 1)
    return np.minimum(np.arange(p)[None, :] + step, p).astype(np.int32)


@pytest.mark.parametrize("p,seg_len,b", [(2, 2, 1), (128, 100, 2), (512, 500, 2),
                                         (2048, 2000, 3), (1 << 17, 130560, 3),
                                         (1 << 18, 250000, 2)])
def test_mark_path_kernel(dev, p, seg_len, b):
    g = torch.from_numpy(_jumps(np.random.default_rng(p), b, p, seg_len)).to(dev)
    before = _build.LAUNCHES["mark_path"]
    got = parse_cu.mark_path(g)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mark_path"] == before + 1
    assert torch.equal(got, parse_cu.mark_path_plain(g))


@pytest.mark.parametrize("step", [1, 258])
def test_mark_path_kernel_extremes(dev, step):
    p = 1 << 15
    g = torch.clamp(torch.arange(p, device=dev, dtype=torch.int32) + step, max=p)
    got = parse_cu.mark_path(g.expand(2, p).contiguous())
    assert got.sum().item() == 2 * len(range(0, p, step))
    assert torch.equal(got, parse_cu.mark_path_plain(g.expand(2, p)))


@pytest.mark.parametrize("p", [1 << 17, 1 << 18])
@pytest.mark.parametrize("jumps", ["plus1000", "random4096"])
def test_mark_path_kernel_long_jumps(dev, p, jumps):
    """Walks entering chunks past the staged 288-exit heads: every step
    1000 long, or random steps up to 4096 (P = 2^18: more chunks than
    the hop's shared-memory ring holds, so the ring wraps)."""
    idx = torch.arange(p, device=dev, dtype=torch.int32)
    if jumps == "plus1000":
        g = torch.clamp(idx + 1000, max=p).expand(3, p).contiguous()
    else:
        rng = np.random.default_rng(p)
        step = np.where(rng.random((3, p)) < 0.5, rng.integers(1, 4097, (3, p)), 1)
        g = torch.from_numpy(np.minimum(np.arange(p) + step, p).astype(np.int32)).to(dev)
    before = _build.LAUNCHES["mark_path"]
    got = parse_cu.mark_path(g)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mark_path"] == before + 1
    assert torch.equal(got, parse_cu.mark_path_plain(g))
    if jumps == "plus1000":
        assert got.sum().item() == 3 * len(range(0, p, 1000))


def _parse_arrays(rng, b, t, dev):
    on_path = rng.random((b, t)) < 0.5
    is_match = on_path & (rng.random((b, t)) < 0.5)
    length = np.where(is_match, rng.integers(3, 259, (b, t)), 0).astype(np.int32)
    dist = np.where(is_match, rng.integers(1, 32769, (b, t)), 0).astype(np.int32)
    batch = rng.integers(0, 256, (b, 64 + t), dtype=np.uint8)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (on_path, is_match, length, dist, batch))


@pytest.mark.parametrize("b,t,case", [
    (1, 300, "random"), (9, 5000, "random"), (8, 130560, "random"), (2, 1, "random"),
    (3, 4103, "random"), (9, 4103, "unaligned"), (8, 130560, "unaligned"),
    (8, 130560, "one_literal"), (8, 130560, "one_match"), (4, 5000, "off_path")])
def test_histograms_kernel(dev, b, t, case):
    """Strided payload rows, 16-byte aligned or not ("unaligned"), T = 1
    and T off a multiple of 16 (byte loads for misaligned rows and the
    row end), every position the same literal or the same match on the
    path (one bin takes every count), and no position on the path or a
    match; every output bin written by the one launch."""
    on_path, is_match, length, dist, batch = _parse_arrays(
        np.random.default_rng(t), b, t, dev)
    lit = batch[:, 64:] if case != "unaligned" else batch[:, 63:63 + t]
    if case == "one_literal":
        on_path, is_match = torch.ones_like(on_path), torch.zeros_like(is_match)
        lit = torch.full_like(batch, 97)[:, 64:]
    elif case == "one_match":
        on_path = is_match = torch.ones_like(on_path)
        length, dist = torch.full_like(length, 258), torch.full_like(dist, 1)
    elif case == "off_path":
        on_path, is_match = torch.zeros_like(on_path), torch.zeros_like(is_match)
    before = _build.LAUNCHES["histograms"]
    got = hist_cu.histograms(on_path, is_match, length, dist, lit)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["histograms"] == before + 1
    want = hist_cu.histograms_plain(on_path, is_match, length, dist, lit)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("b,t", [(1, 300), (9, 5000), (8, 130560)])
def test_slots_kernel(dev, b, t):
    rng = np.random.default_rng(t + 1)
    on_path, is_match, length, dist, batch = _parse_arrays(rng, b, t, dev)
    lit_cb = torch.from_numpy(rng.integers(0, 1 << 19, (b, 286)).astype(np.int32)).to(dev)
    dist_cb = torch.from_numpy(rng.integers(0, 1 << 19, (b, 30)).astype(np.int32)).to(dev)
    args = (on_path, is_match, length, dist, batch[:, 64:], lit_cb, dist_cb)
    v01, n01, v23, n23 = pack_cu.build_slots(*args)
    w01, m01, w23, m23 = pack_cu.build_slots_plain(*args)
    assert torch.equal(n01, m01) and torch.equal(n23, m23)
    one = torch.ones_like(n01)
    assert torch.equal(v01 & ((one << n01) - 1), w01 & ((one << m01) - 1))
    assert torch.equal(v23 & ((one << n23) - 1), w23 & ((one << m23) - 1))


@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("b,t", [(1, 300), (9, 5000), (8, 130560), (2, 1), (3, 3 * 4096 + 17)])
def test_litbits_kernel(dev, b, t, aligned):
    """Literal bits and their prefix, on payload rows that are 16-byte
    aligned (one vector load a thread, a ragged row end) or not (byte
    loads)."""
    rng = np.random.default_rng(t + 2)
    width = 64 + (-(-t // 16) * 16 if aligned else t)
    batch = torch.from_numpy(rng.integers(0, 256, (b, width), dtype=np.uint8)).to(dev)
    lit = batch[:, 64:64 + t]
    lcost = torch.from_numpy(rng.integers(1, 16, (b, 286)).astype(np.int32)).to(dev)
    before = _build.LAUNCHES["litbits"]
    bits, pref = cost_cu.litbits_pref(lit, lcost)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["litbits"] == before + 1
    want_bits, want_pref = cost_cu.litbits_pref_plain(lit, lcost)
    assert torch.equal(bits, want_bits)
    assert torch.equal(pref, want_pref)


@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("b,t", [(1, 300), (9, 5000), (8, 130560)])
def test_gain_kernel(dev, b, t, hot):
    rng = np.random.default_rng(t + 3)

    def put(a):
        return torch.from_numpy(a.astype(np.int32)).to(dev)

    lcost, dcost = put(rng.integers(1, 16, (b, 286))), put(rng.integers(1, 16, (b, 30)))
    lb = torch.gather(lcost, 1, put(rng.integers(0, 256, (b, t))).long())
    pref = torch.cat([torch.zeros_like(lb[:, :1]), torch.cumsum(lb, 1, dtype=torch.int32)], 1)
    ln = rng.integers(0, 259, (b, t))
    ln[:, -300:] = 258  # matches running into the row end
    length, dist = put(ln), put(rng.integers(1, 32769, (b, t)))
    hl = hd = None
    if hot:
        hl, hd = put(rng.integers(0, 259, (b, t))), put(rng.integers(1, 32769, (b, t)))
    before = _build.LAUNCHES["gain"]
    got = cost_cu.gain(length, dist, hl, hd, pref, lcost, dcost)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["gain"] == before + 1
    want = cost_cu.gain_plain(length, dist, hl, hd, pref, lcost, dcost)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case,kw", chip_smoke.ROUND_A_CASES)
def test_probe_and_extend_kernels(dev, case, kw):
    """Both kernels equal their plain versions on the inputs round A
    gives them (chip_smoke.round_a_rows: the extremes batch has an
    all-zero row, every rank a hit and runs of 258, and random rows with
    no hits)."""
    calls = chip_smoke.round_a_calls(torch, dev, np.frombuffer(_corpus_8mib(), np.uint8),
                                     case, kw)
    outs = {}
    for name, plain in (("probe", probe_cu.probe_plain), ("extend", probe_cu.extend_plain)):
        args, k = calls[name]
        before = _build.LAUNCHES[name]
        got = getattr(probe_cu, name)(*args, **k)
        torch.cuda.synchronize()
        assert _build.LAUNCHES[name] == before + 1
        want = plain(*args, **k)
        assert (got[1] is None) == (want[1] is None)
        for g, w in zip(got, want):
            if w is not None:
                assert torch.equal(g, w), name
        outs[name] = got
    if case == "extremes":
        assert bool((outs["extend"][0][0, :-258] == 258).all())
        # random rows: a 4-byte match in the window is a chance event
        assert int((outs["probe"][0][1:3] & 1).sum()) < 64


def _same_fields(got, want):
    """fields' outputs (w, key, rec, spans, runs) equal, None where None."""
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if isinstance(w, tuple):
            assert len(g) == len(w) and all(torch.equal(a, b) for a, b in zip(g, w))
        elif w is not None:
            assert torch.equal(g, w)


@pytest.mark.parametrize("case,kw", chip_smoke.ROUND_A_CASES)
def test_fields_kernel(dev, case, kw):
    """The fields kernel equals fields_plain on the bytes round A gives it
    (an all-zero row among the extremes: runs of 258 everywhere)."""
    calls = chip_smoke.round_a_calls(torch, dev, np.frombuffer(_corpus_8mib(), np.uint8),
                                     case, kw)
    args, k = calls["fields"]
    before = _build.LAUNCHES["fields"]
    got = probe_cu.fields(*args, **k)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fields"] == before + 1
    _same_fields(got, probe_cu.fields_plain(*args, **k))


def _small_rows(t):
    """uint8[3, t]: corpus text, one repeated byte, random bytes."""
    raw = np.frombuffer((CORPUS / "paper1").read_bytes(), np.uint8)
    data = np.zeros((3, t), np.uint8)
    data[0] = raw[5000:5000 + t]
    data[1] = 0x61
    data[2] = np.random.default_rng(16).integers(0, 256, t, dtype=np.uint8)
    return data


@pytest.mark.parametrize("t", [4999, 4097, 150])
@pytest.mark.parametrize("hist", [0, 100])
@pytest.mark.parametrize("level,force_exact", [
    (1, False), (4, False), (6, False), (12, False), (4, True), (6, True)])
def test_candidate_search_kernels_small(dev, level, force_exact, hist, t):
    """fields, probe and extend equal their plain versions in
    ``_match_candidates`` of short rows (T off every tile, just over a
    power of two, under the 223 bytes a record reads), with and without
    history."""
    cfg = lz77.level_config(level)
    if force_exact:
        cfg = dataclasses.replace(cfg, exact=True)
    data = torch.from_numpy(_small_rows(t)).to(dev)
    lim = torch.tensor([[0], [hist], [hist]], dtype=torch.int64, device=dev)
    calls = chip_smoke.captured_args(
        probe_cu, chip_smoke.CANDIDATE_SEARCH,
        lambda: lz77._match_candidates(data, lim, torch.full_like(lim, t), cfg,
                                       max_dist=1 << 15, hist=hist))
    args, k = calls["fields"]
    _same_fields(probe_cu.fields(*args, **k), probe_cu.fields_plain(*args, **k))
    for name in ("probe", "extend"):
        args, k = calls[name]
        got, want = getattr(probe_cu, name)(*args, **k), getattr(probe_cu, f"{name}_plain")(
            *args, **k)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                assert torch.equal(g, w), name


def test_probe_and_extend_reject_bad_tensors(dev):
    skey = torch.zeros((2, 100), dtype=torch.int64, device=dev)
    lim = torch.zeros((2, 1), dtype=torch.int64, device=dev)
    rec = torch.zeros((2, 100, 9), dtype=torch.int32, device=dev)
    kw = dict(hist=10, max_dist=1 << 15, full_ladder=True, top2=False)
    with pytest.raises(ValueError):  # the short ladder's record is 4 wide
        probe_cu.probe(skey, 7, rec, lim, lim, k=8, **{**kw, "full_ladder": False})
    with pytest.raises(ValueError):
        probe_cu.probe(skey, 7, rec, lim, lim, k=probe_cu.MAX_K + 1, **kw)
    with pytest.raises(TypeError):
        probe_cu.probe(skey.to(torch.int32), 7, rec, lim, lim, k=8, **kw)
    w = skey.clone()
    packed = torch.zeros((2, 90), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):  # "span" needs the fingerprints
        probe_cu.extend(w, packed, None, None, None, None, lim, lim, hist=10, mode="span")
    with pytest.raises(ValueError):
        probe_cu.extend(w, packed[:, 1:], None, None, None, None, lim, lim, hist=10,
                        mode="rec")
    with pytest.raises(ValueError):  # the full ladder's record is 8 words
        probe_cu.probe(skey, 7, rec, lim, lim, k=8, **kw)
    data = torch.zeros((2, 100), dtype=torch.uint8, device=dev)
    fkw = dict(full_ladder=True, spans=False, runs=True)
    with pytest.raises(TypeError):
        probe_cu.fields(data.to(torch.int32), hist=10, **fkw)
    with pytest.raises(ValueError):
        probe_cu.fields(data, hist=100, **fkw)
    with pytest.raises(ValueError):
        probe_cu.fields(data[:, ::2], hist=10, **fkw)


def test_wrappers_reject_bad_tensors(dev):
    with pytest.raises(TypeError):
        parse_cu.mark_path(torch.zeros((1, 1024), dtype=torch.int64, device=dev))
    with pytest.raises(ValueError):
        parse_cu.mark_path(torch.zeros((1, 1000), dtype=torch.int32, device=dev))
    z = torch.zeros((2, 100), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # pref must be [B, T + 1]
        cost_cu.gain(z, z, None, None, z, z[:, :1].expand(2, 286).contiguous(),
                     z[:, :30].contiguous())
    with pytest.raises(TypeError):  # the payload is uint8
        cost_cu.litbits_pref(z, torch.zeros((2, 286), dtype=torch.int32, device=dev))


@pytest.mark.parametrize("level", [1, 4, 6, 9])
def test_gzip_on_card_matches_cpu(dev, level):
    x = (CORPUS / "paper1").read_bytes()
    out = gz.compress(x, level=level, segment_size=4096, device="cuda")
    assert out == gz.compress(x, level=level, segment_size=4096, device="cpu")
    assert gzip.decompress(out) == x


@functools.lru_cache(maxsize=2)
def _archive_plan(data, member_size):
    buf = np.frombuffer(sharded.sharded_gzip_compress(
        data, 6, member_size=member_size, device="cpu"), np.uint8)
    plan = sharded.decode_plan(buf)
    return plan.metas, plan.huff, plan.rows, plan.max_cmds()


def _archive_rows(dev, data, member_size, flip=None, rows_of=None):
    """Staged decode rows of the port's level-6 archive of ``data``; with
    ``flip="eob"``, one bit of the first member's end-of-block code
    flipped, with ``flip="interior"``, 40 random bits of every member's
    first row; ``rows_of(rows)`` may replace the split rows."""
    metas, huff, rows, max_cmds = _archive_plan(data, member_size)
    bodies = [metas[i][1].copy() for i in huff]
    if flip == "eob":
        bodies[0][-1] ^= 1 << 7 if bodies[0][-1] >> 7 else 1
    elif flip == "interior":
        rng = np.random.default_rng(11)
        for body, r in zip(bodies, rows):
            for bit in rng.integers(r[0][0], r[0][1] or body.size * 8, 40):
                body[bit >> 3] ^= 1 << (bit & 7)
    st = inflate_cu.stage(bodies, [metas[i][0][1] for i in huff],
                          [metas[i][0][2] for i in huff],
                          rows if rows_of is None else rows_of(rows), dev)
    return st, max_cmds


def _decode_both(st, max_cmds):
    args = (st["words"], st["tabs"], st["row_ptr"], st["start"], st["stop"], st["nbits"],
            st["blocks"], max_cmds)
    before = _build.LAUNCHES["decode"]
    got = inflate_cu.decode(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["decode"] == before + 1
    want = inflate_cu.decode_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return got


@pytest.mark.parametrize("member_size", [4096, 130560])
def test_decode_kernel(dev, member_size):
    rng = np.random.default_rng(member_size)
    x = (CORPUS / "book1").read_bytes()[:300_000]
    x += rng.integers(0, 256, member_size, np.uint8).tobytes() + bytes(70_000)
    st, max_cmds = _archive_rows(dev, x, member_size)
    cmds, ok, ncmds = _decode_both(st, max_cmds)
    assert ok.all() and st["row_ptr"][-1] > st["row_ptr"].numel()
    assert torch.equal(ncmds, inflate.slot_counts_bits(cmds >> 26, st["stop"]))
    # the first member's final row decodes on into the zero padding
    st, max_cmds = _archive_rows(dev, x, member_size, flip="eob")
    _, ok_bad, _ = _decode_both(st, max_cmds)
    last = int(st["row_ptr"][1]) - 1
    assert (~ok_bad).nonzero().flatten().tolist() == [last]
    # flipped bits inside interior rows: invalid codes for the lanes
    st, max_cmds = _archive_rows(dev, x, member_size, flip="interior")
    _decode_both(st, max_cmds)
    # max_cmds one below, at and one above the true count of a row
    st, max_cmds = _archive_rows(dev, x, member_size)
    c = int(ncmds[0])
    for cap in (c - 1, c, c + 1):
        _, ok_cap, n_cap = _decode_both(st, cap)
        assert bool(ok_cap[0]) == (cap >= c) and int(n_cap[0]) == min(c, cap)
    # rows of 1-100 bits: lane ranges shorter than a long command
    lens = (1, 2, 5, 31, 32, 33, 47, 48, 63, 64, 65, 100)
    st, _ = _archive_rows(dev, x, member_size, rows_of=lambda rows: [
        [(r[0][0] + k, r[0][0] + k + n) for k in (0, 7) for n in lens] for r in rows])
    _decode_both(st, 64)


def test_decode_kernel_fixed_member(dev):
    x = (CORPUS / "paper1").read_bytes()[:3000]
    c = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)
    body = np.frombuffer(c.compress(x) + c.flush(), np.uint8)
    _, ll, dl, start = inflate.prepare_member(body)
    st = inflate_cu.stage([body], [ll], [dl], [[(start, 0)]], dev)
    cmds, ok, ncmds = _decode_both(st, len(x) + 2)
    assert ok.all() and int(ncmds[0]) <= len(x) + 1
    # rows starting before and far past the body read only clamped words
    past = body.size * 8 + 4096
    st = inflate_cu.stage([body, body, body], [ll] * 3, [dl] * 3,
                          [[(-40, 0)], [(past, 0)],
                           [(-40, 300), (past, past + 500), (past + 10, past + 5)]], dev)
    _decode_both(st, 64)


@pytest.mark.parametrize("width", [300, 130560])
def test_crc_kernel(dev, width):
    """crc32_rows on the card: equal to its plain version on zero-tailed
    rows and to zlib with init values, nonzero junk past each length and
    rows misaligned by a strided view; one launch a call; crc32_batch of
    host rows with junk past each length."""
    rng = np.random.default_rng(width)
    lengths = np.array([0, 1, 15, 16, 17, 255, 256, 257, width - 3, width])
    data = np.zeros((lengths.size, width + 7), np.uint8)
    for i, n in enumerate(lengths):
        data[i, :n] = rng.integers(0, 256, n, dtype=np.uint8)
    init = rng.integers(0, 1 << 32, lengths.size)
    rows = torch.from_numpy(data).to(dev)[:, :width]
    d_len = torch.from_numpy(lengths.astype(np.int32)).to(dev)
    d_init = torch.from_numpy(init).to(dev)
    before = _build.LAUNCHES["crc32_rows"]
    got = crc_cu.crc32_rows(rows, d_len, d_init)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["crc32_rows"] == before + 1
    assert torch.equal(got, crc_cu.crc32_rows_plain(rows, d_len, d_init))
    junk = np.where(np.arange(width + 7)[None, :] < lengths[:, None], data,
                    rng.integers(1, 256, data.shape, dtype=np.uint8))
    for off in (0, 5):
        shifted = torch.from_numpy(junk).to(dev)[:, off:]
        want = [zlib.crc32(junk[i, off:off + n].tobytes(), int(init[i]))
                for i, n in enumerate(np.minimum(lengths, width + 7 - off))]
        assert crc_cu.crc32_rows(shifted, d_len, d_init).tolist() == want
    crcs = checksum.crc32_batch_device(rows, lengths)
    assert crcs.tolist() == [zlib.crc32(data[i, :n].tobytes()) for i, n in enumerate(lengths)]
    host = checksum.crc32_batch(junk[:, :width], lengths)  # host rows, junk past lengths
    assert host.tolist() == crcs.tolist()


@pytest.mark.parametrize("expand", ["auto", "device"])
def test_sharded_round_trip_on_card(dev, expand):
    sharded.serial_fallbacks.clear()
    x = (CORPUS / "book1").read_bytes()[:200_000] + bytes(50_000)
    arch = sharded.sharded_gzip_compress(x, member_size=65536, device="cuda")
    assert arch == sharded.sharded_gzip_compress(x, member_size=65536, device="cpu")
    assert gzip.decompress(arch) == x
    _build.LAUNCHES.clear()
    assert sharded.sharded_gzip_decompress(arch, expand=expand, device="cuda") == x
    assert not sharded.serial_fallbacks
    assert _build.LAUNCHES["decode"] == 1
    # a CRC launch per stored member on both routes, and one for all the
    # decoded members on the device route
    metas = sharded.decode_plan(np.frombuffer(bytes(arch), np.uint8)).metas
    stored = sum(p[0] == "stored" for p, *_ in metas)
    assert _build.LAUNCHES["crc32_rows"] == stored + (expand == "device")


def test_decode_routes_reject_a_flipped_crc_on_card(dev):
    """A CRC-32 mismatch after the card decode, on both expand routes:
    the member decodes again whole on the card, still mismatches, and the
    counted serial route raises the reference's error."""
    x = (CORPUS / "book1").read_bytes()[:200_000]
    arch = bytearray(sharded.sharded_gzip_compress(x, member_size=65536, device="cuda"))
    arch[-5] ^= 1  # the last member's CRC-32
    for expand in ("auto", "device"):
        sharded.serial_fallbacks.clear()
        sharded.card_retries.clear()
        with pytest.raises(gz.MalformedError, match="^invalid checksum$"):
            sharded.sharded_gzip_decompress(bytes(arch), expand=expand, device="cuda")
        counted = {"member length or CRC-32 mismatch": 1}
        assert sharded.serial_fallbacks == counted and sharded.card_retries == counted


def _corpus_8mib() -> bytes:
    """chip_smoke.py's corpus: the corpus files, sorted, concatenated,
    repeated and cut to 8 MiB (65 segments: 9 batches)."""
    base = b"".join(p.read_bytes() for p in sorted(CORPUS.iterdir()))
    return (base * -(-(8 << 20) // len(base)))[:8 << 20]


#: the reference's default-level gzip of _corpus_8mib() (chip_smoke.EXPECT)
LEVEL6_EXPECT = (2854697, "eafff4741db8b10690dc785fcd9e4cbcf5d6dc0eb07cba3c199fe36e754842f4")


@functools.lru_cache(maxsize=1)
def _index_archives() -> dict:
    """The level-6 archive of the 8 MiB corpus with the legacy TS index
    (SPLIT_BITS 0: a triple every 2,048 commands) and with its TB index
    cut to the member sizes."""
    x = _corpus_8mib()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sharded, "SPLIT_BITS", 0)
        ts = sharded.sharded_gzip_compress(x, device="cuda")
    return {"ts": ts, "sizes_only": sizes_only(sharded.sharded_gzip_compress(x, device="cuda"))}


@pytest.mark.parametrize("expand", ["auto", "device"])
@pytest.mark.parametrize("name", ["ts", "sizes_only"])
def test_ts_and_sizes_only_archives_on_card(dev, name, expand):
    """Archives with no bit-stride index decode on the card in one
    launch, to the corpus, with no serial fallback."""
    arch = _index_archives()[name]
    buf = np.frombuffer(arch, np.uint8)
    splits, tb = sharded._read_index_ex(buf)[1:]
    assert tb is None and (splits is None) == (name == "sizes_only")
    plan = sharded.decode_plan(buf)
    assert (max(map(len, plan.rows)) > 1) == (name == "ts")
    sharded.serial_fallbacks.clear()
    _build.LAUNCHES.clear()
    assert sharded.sharded_gzip_decompress(arch, expand=expand, device="cuda") == _corpus_8mib()
    assert not sharded.serial_fallbacks
    assert _build.LAUNCHES["decode"] == len(sharded._groups(plan)) == 1
    assert _build.LAUNCHES["crc32_rows"] == (expand == "device")


def test_group_staging_on_card(dev, monkeypatch):
    """With the group bound lowered to 8 whole-member rows, the sizes-only
    archive decodes in 9 launches to the same bytes on both routes."""
    arch = _index_archives()["sizes_only"]
    plan = sharded.decode_plan(np.frombuffer(arch, np.uint8))
    monkeypatch.setattr(sharded, "GROUP_BYTES", 8 * (max(plan.caps) + 4) * 4)
    groups = sharded._groups(plan)
    assert len(groups) == -(-len(plan.huff) // 8)
    for expand in ("auto", "device"):
        sharded.serial_fallbacks.clear()
        _build.LAUNCHES.clear()
        assert sharded.sharded_gzip_decompress(arch, expand=expand, device="cuda") == \
            _corpus_8mib()
        assert _build.LAUNCHES["decode"] == len(groups) and not sharded.serial_fallbacks


def test_decode_kernel_whole_member_rows(dev):
    """The decode kernel == its plain version on whole-member rows (one
    row a member, to the end-of-block, ~360,000 bits) of the corpus's
    first 6 members at the cap isize + 2 (the plain loop takes ~50 s);
    with the cap one below a member's command count the kernel rejects
    that row (the plain version is held there on split rows)."""
    plan = sharded.decode_plan(np.frombuffer(_index_archives()["sizes_only"], np.uint8))
    huff = plan.huff[:6]
    st = inflate_cu.stage([plan.metas[i][1] for i in huff], [plan.metas[i][0][1] for i in huff],
                          [plan.metas[i][0][2] for i in huff], plan.rows[:6], dev)
    cmds, ok, ncmds = _decode_both(st, plan.max_cmds(0, 6))
    assert ok.all() and int(ncmds.min()) > 10_000
    cap = int(ncmds[0]) - 1
    _, ok_cap, n_cap = inflate_cu.decode(st["words"], st["tabs"], st["row_ptr"], st["start"],
                                         st["stop"], st["nbits"], st["blocks"], cap)
    assert ok_cap.tolist() == (ncmds <= cap).tolist() and not bool(ok_cap[0])
    assert torch.equal(n_cap, ncmds.clamp(max=cap))


def test_pipeline_depths_match_reference_digest(dev, monkeypatch):
    x = _corpus_8mib()
    out = gz.compress(x, device="cuda")
    assert (len(out), hashlib.sha256(out).hexdigest()) == LEVEL6_EXPECT
    monkeypatch.setattr(de, "PIPELINE_DEPTH", 1)
    assert gz.compress(x, device="cuda") == out


def test_pipelined_host_reads_match_blocking_reads(dev, monkeypatch):
    """Every host read of the pipelined writer and the windowed sharded
    writer, as the code received it from its event-ordered copy, equals a
    blocking re-read of the same device tensors: a pinned buffer read
    before its event fired would differ."""
    checked = []
    wait = transfer.Fetch.wait

    def checked_wait(self, *keys):
        arrays = wait(self, *keys)
        got = [a.copy() for a in arrays]  # as received, before anything syncs
        for k, g in zip(keys, got):
            want = self.sources[k].cpu().numpy()
            assert np.array_equal(g, want), k
            checked.append(k)
        return arrays

    monkeypatch.setattr(transfer.Fetch, "wait", checked_wait)
    x = _corpus_8mib()[: 6 << 20]  # 49 segments: 7 batches, 7 chunks
    assert hashlib.sha256(gz.compress(x, device="cuda")).hexdigest() == \
        hashlib.sha256(gz.compress(x, device="cpu")).hexdigest()
    arch = sharded.sharded_gzip_compress(x, device="cuda")
    assert gzip.decompress(arch) == x
    assert {"exact", "hist_lit", "hist_dist", "dist_counts", "totals", "words",
            "crcs"} <= set(checked)


def test_pipelined_writers_never_block_the_stream(dev):
    """Under torch's sync debug mode set to raise, the pipelined gzip and
    the windowed sharded writer run with no blocking copy and no stream or
    device synchronize (the one-time device tables are made first)."""
    x = _corpus_8mib()[: 5 << 20]
    want = gz.compress(x, device="cuda")
    want_a = sharded.sharded_gzip_compress(x, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = gz.compress(x, device="cuda")
        got_a = sharded.sharded_gzip_compress(x, device="cuda")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert got == want and got_a == want_a


@pytest.mark.parametrize("kw", [dict(level=1), dict(level=6), dict(level=9),
                                dict(level=6, window_bits=10, zdict=b"dictionary " * 40)],
                         ids=["l1", "l6", "l9", "wbits10_zdict"])
def test_zlib_on_card_matches_cpu(dev, kw):
    x = (CORPUS / "book1").read_bytes()[:300_000]
    got = zl.deflate(x, device="cuda", **kw)
    assert got == zl.deflate(x, device="cpu", **kw)
    assert zl.inflate(got, zdict=kw.get("zdict")) == x


def test_sharded_zlib_on_card_matches_cpu(dev):
    x = (CORPUS / "book1").read_bytes()[:200_000] + bytes(50_000)
    got = sharded.sharded_zlib_compress(x, member_size=65536, device="cuda")
    assert got == sharded.sharded_zlib_compress(x, member_size=65536, device="cpu")
    assert zlib.decompress(got) == x


@pytest.mark.parametrize("n", [0, 1, 511, 512, 513, 5552, 5553, 1 << 20, (8 << 20) + 3])
def test_adler32_on_card(dev, n):
    rng = np.random.default_rng(n)
    x = rng.integers(0, 256, n, dtype=np.uint8)
    t = torch.from_numpy(x).to(dev)
    assert checksum.adler32(t) == zlib.adler32(x.tobytes())
    start = int(rng.integers(0, 1 << 32))
    assert checksum.adler32(x, start, device="cuda") == zlib.adler32(x.tobytes(), start)
    ones = torch.full((n,), 255, dtype=torch.uint8, device=dev)
    assert checksum.adler32(ones) == zlib.adler32(b"\xff" * n)


def _streamed(enc, x, piece=10_000):
    return b"".join(enc.push(x[i:i + piece]) for i in range(0, len(x), piece)) + enc.finish()


@pytest.mark.parametrize("seg", [8192, None])
def test_streaming_gzip_on_card_matches_cpu(dev, seg):
    x = (CORPUS / "book1").read_bytes()[:40_000]
    kw = dict(segment_size=seg, filename="s")
    _build.LAUNCHES.clear()
    got = _streamed(gz.Def(6, device="cuda", **kw), x)
    assert all(_build.LAUNCHES[k] > 0 for k in ("mark_path", "histograms", "litbits",
                                                "gain", "build_slots"))
    assert got == _streamed(gz.Def(6, device="cpu", **kw), x)
    assert gzip.decompress(got) == x


@pytest.mark.parametrize("mod", [zl, gz])
def test_queue_engine_on_card_matches_cpu(dev, mod):
    x = (CORPUS / "paper2").read_bytes()[:40_000]
    _build.LAUNCHES.clear()
    got = _streamed(mod.Def(6, engine="queue", device="cuda"), x)
    assert all(_build.LAUNCHES[k] > 0 for k in ("mark_path", "histograms", "litbits",
                                                "gain"))
    assert got == _streamed(mod.Def(6, engine="queue", device="cpu"), x)
    assert (zlib.decompress(got) if mod is zl else gzip.decompress(got)) == x


def test_match_commands_batch_on_card_matches_cpu(dev):
    raw = (CORPUS / "book1").read_bytes()
    chunks = [raw[i:i + 16384] for i in range(40_000, 40_000 + 7 * 16384, 16384)]
    chunks.append(raw[200_000:203_000])
    hists = [raw[max(0, 40_000 + 16384 * i - 32768):40_000 + 16384 * i] for i in range(7)]
    hists.append(b"")
    got = de.match_commands_batch(chunks, hists, 6, seg=16384, device="cuda")
    want = de.match_commands_batch(chunks, hists, 6, seg=16384, device="cpu")
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [20_000, 300_000])
def test_lzo_on_card_matches_cpu(dev, n):
    base = b"".join(p.read_bytes() for p in sorted(CORPUS.iterdir()))[:n]
    _build.LAUNCHES.clear()
    got = lzo.compress(base, level=6, device="cuda")
    assert _build.LAUNCHES["mark_path"] > 0 and _build.LAUNCHES["histograms"] > 0
    assert got == lzo.compress(base, level=6, device="cpu")
    assert lzo.uncompress(got) == base


def _fixed_rows(b, seg, hist_len):
    raw = np.frombuffer((CORPUS / "book1").read_bytes(), np.uint8)
    data = np.zeros((b, lz77.HIST + seg), np.uint8)
    for i in range(b):
        st = lz77.HIST + 5000 * i
        data[i, lz77.HIST - hist_len:] = raw[st - hist_len:st + seg]
    nv = np.full(b, seg, np.int32)
    nv[-1] = seg - 1000
    data[-1, lz77.HIST + seg - 1000:] = 0
    hl = np.full(b, hist_len, np.int32)
    bf = np.ones(b, np.int32)
    return data, nv, hl, bf


@pytest.mark.parametrize("b,seg,hist_len", [(2, 4096, 0), (8, 1 << 17, 0), (3, 1024, 700)])
def test_fixed_step_on_card_matches_cpu(dev, b, seg, hist_len):
    arrs = _fixed_rows(b, seg, hist_len)
    _build.LAUNCHES.clear()
    words, bits = pipeline.fixed_deflate_segments(
        *(torch.from_numpy(a).to(dev) for a in arrs), seg_len=seg)
    assert _build.LAUNCHES["mark_path"] > 0 and _build.LAUNCHES["histograms"] > 0
    want_w, want_t = pipeline.fixed_deflate_segments(
        *(torch.from_numpy(a) for a in arrs), seg_len=seg)
    assert words.dtype == torch.uint32 and bits.dtype == torch.int32
    assert torch.equal(words.cpu(), want_w) and torch.equal(bits.cpu(), want_t)
    data, nv, hl, _ = arrs
    for i in range(b):
        body = bitpack.words_to_bytes(words[i], int(bits[i]))
        d = zlib.decompressobj(-15, zdict=data[i, lz77.HIST - hl[i]:lz77.HIST].tobytes())
        assert d.decompress(body) == data[i, lz77.HIST:lz77.HIST + nv[i]].tobytes()


def test_compress_step_and_mesh_archive_on_card_match_cpu(dev):
    arrs = _fixed_rows(8, 4096, 0)
    want = parallel.compress_step_sharded(parallel.make_mesh(2, device="cpu"), *arrs,
                                          seg_len=4096)
    for mesh in (parallel.make_mesh(), (dev, dev)):
        got = parallel.compress_step_sharded(mesh, *arrs, seg_len=4096)
        want_m = parallel.compress_step_sharded(parallel.make_mesh(len(mesh), device="cpu"),
                                                *arrs, seg_len=4096)
        for g, w in zip(got, want_m):
            assert g.device.type == "cuda" and torch.equal(g.cpu(), w)
        assert int(got[2]) == int(want[2])
    x = (CORPUS / "book1").read_bytes()[:300_000]
    want_a = sharded.sharded_gzip_compress(x, member_size=16384, device="cpu")
    for mesh in (parallel.make_mesh(), (dev, dev)):
        assert sharded.sharded_gzip_compress(x, member_size=16384, mesh=mesh) == want_a


# ---------------------------------------------------------------------------
# The captured programs (ops/graphs): replays against the eager functions.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def program_cases():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    arr = np.frombuffer(_corpus_8mib(), np.uint8)
    return chip_smoke.program_cases(torch, torch.device("cuda"), arr)


def test_programs_replay_equal_to_eager(program_cases):
    """Round A at levels 6 and 12 and of the B = 1 tail, round B with hot
    strides, the trims, the re-parse, the pack with splits and the fixed
    step, at the main paths' shapes: the capturing call and a replay
    equal the eager function in every output, and a replay returns
    clones, not the graph's static outputs."""
    graphs.clear()
    for label, prog, args, kw in program_cases:
        want = prog.eager(*args, **kw)
        first = prog(*args, **kw)
        entry = graphs.captured(0)[-1]
        replay = prog(*args, **kw)
        assert chip_smoke.same_leaves(torch, first, want), label
        assert chip_smoke.same_leaves(torch, replay, want), label
        static = {t.data_ptr() for t in entry.outputs}
        assert not static & {t.data_ptr() for t in chip_smoke.program_leaves(replay)}, label


def test_replays_leave_earlier_results(program_cases):
    """Two replays of one key with different inputs: the first call's
    returned outputs are unchanged after the second."""
    _, prog, args, kw = program_cases[0]
    prog(*args, **kw)
    first = prog(*args, **kw)
    kept = [t.clone() for t in chip_smoke.program_leaves(first)]
    other = [torch.roll(a, 1, 0) for a in args]
    second = prog(*other, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(chip_smoke.program_leaves(first), kept))
    assert chip_smoke.same_leaves(torch, second, prog.eager(*other, **kw))


def test_replays_count_the_captured_launches(program_cases):
    """The capture counts what its eager run launched; each replay adds
    that delta to _build.LAUNCHES, and nothing else does."""
    graphs.clear()
    _, prog, args, kw = program_cases[0]
    before = collections.Counter(_build.LAUNCHES)
    prog(*args, **kw)
    eager = _build.LAUNCHES - before
    (entry,) = graphs.captured(0)
    assert entry.launches == eager and set(eager) == {"fields", "probe", "extend",
                                                      "mark_path", "histograms"}
    assert eager["fields"] == 1
    _build.LAUNCHES.clear()
    prog(*args, **kw)
    prog(*args, **kw)
    assert _build.LAUNCHES == collections.Counter({k: 2 * n for k, n in eager.items()})


def test_replays_on_two_streams_from_two_threads(program_cases):
    """Two threads, each on its own CUDA stream, replay one round-A key
    (level 6, the production batch) on different inputs, several times
    each, started together: every result equals the eager function's on
    its own inputs, so no replay's copy into the key's static inputs lands
    under another stream's running replay."""
    _, prog, args, kw = program_cases[0]
    inputs = [list(args), [torch.roll(a, 1, 0) for a in args]]
    want = [prog.eager(*a, **kw) for a in inputs]
    prog(*args, **kw)  # the key is captured before the threads start
    torch.cuda.synchronize()
    results: list = [[], []]
    errors: list = []
    start = threading.Barrier(2)

    def run(i):
        try:
            stream = torch.cuda.Stream()
            with torch.cuda.stream(stream):
                start.wait()
                for _ in range(6):
                    results[i].append(prog(*inputs[i], **kw))
            stream.synchronize()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert not errors, errors
    for i in range(2):
        assert len(results[i]) == 6
        for got in results[i]:
            assert chip_smoke.same_leaves(torch, got, want[i]), i


@graphs.program()
def _syncs(x):
    return x * int(x.sum())


@graphs.program()
def _scaled(x):
    return torch.cumsum(x * 3, 0) + 1


def test_a_capture_that_syncs_raises(dev):
    """A function that reads a device value on the host runs eagerly, but
    its capture raises, every time: nothing falls back."""
    x = torch.arange(6, device=dev)
    assert torch.equal(_syncs.eager(x), x * 15)
    graphs.clear()
    for _ in range(2):
        with pytest.raises(RuntimeError):
            _syncs(x)
        assert torch.cuda.current_stream(dev) == torch.cuda.default_stream(dev)
    assert graphs.captured(0) == []
    assert torch.equal(_scaled(x), _scaled.eager(x)) and len(graphs.captured(0)) == 1


def test_lru_evicts_and_recaptures(dev, monkeypatch):
    monkeypatch.setattr(graphs, "MAX_PROGRAMS", 2)
    graphs.clear()
    xs = [torch.arange(n, device=dev) for n in (5, 6, 7)]
    for x in xs:
        _scaled(x)
    assert [e.key[-1][0][0] for e in graphs.captured(0)] == [(6,), (7,)]
    captures = graphs.CAPTURES["_scaled"]
    assert torch.equal(_scaled(xs[0] + 1), _scaled.eager(xs[0] + 1))  # captured again
    assert graphs.CAPTURES["_scaled"] == captures + 1
    assert torch.equal(_scaled(xs[0] + 2), _scaled.eager(xs[0] + 2))  # a replay
    assert graphs.CAPTURES["_scaled"] == captures + 1
    assert [e.key[-1][0][0] for e in graphs.captured(0)] == [(7,), (5,)]


def test_span_holds_its_kernel_on_the_profiler_clock(dev):
    """A kernel launched and synchronized inside a span has its device
    interval in the profile inside the span's (``time.time_ns()``),
    widened by 0.1 ms: spans and device events share one clock."""
    from torch.profiler import ProfilerActivity, profile

    from decompress_tpu_torch.utils import profiling

    x = torch.randint(0, 256, (8, 130560), dtype=torch.uint8, device=dev)
    lengths = torch.full((8,), 130560, dtype=torch.int32, device=dev)
    crc_cu.crc32_rows(x, lengths)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            profiling.tracing() as spans:
        for _ in range(5):
            with profiling.span("schedule.stage"):
                crc_cu.crc32_rows(x, lengths)
                torch.cuda.synchronize()
            time.sleep(0.002)
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == cuda and "crc_rows_kernel" in e.name())
    assert len(kernels) == len(spans) == 5
    for (k0, k1), s in zip(kernels, sorted(spans, key=lambda s: s.start_ns)):
        assert s.start_ns - 100_000 <= k0 <= k1 <= s.end_ns + 100_000, (k0, k1, s)


def test_spans_and_counters_on_the_card(dev):
    """Traced, the writers still never block the stream; each replay is
    one ``programs.dispatch`` span and one count of ``graphs.REPLAYS``;
    the transfers' spans fire and their counters move (uploads, fetches
    and waits in the writers and in the decode)."""
    from decompress_tpu_torch.utils import profiling

    x = _corpus_8mib()[: 2 << 20]
    want = gz.compress(x, device="cuda")
    arch = sharded.sharded_gzip_compress(x, device="cuda")
    torch.cuda.synchronize()
    replays, counts = sum(graphs.REPLAYS.values()), collections.Counter(transfer.COUNTS)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with profiling.tracing() as spans:
            got = gz.compress(x, device="cuda")
            got_a = sharded.sharded_gzip_compress(x, device="cuda")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert got == want and got_a == arch
    names = collections.Counter(s.name for s in spans)
    assert names["programs.dispatch"] == sum(graphs.REPLAYS.values()) - replays > 0
    assert {"transfer.upload", "transfer.fetch", "transfer.wait", "plan.blocks",
            "roundb.tables", "schedule.stage", "schedule.assemble"} <= set(names)
    moved = collections.Counter(transfer.COUNTS) - counts
    assert moved["uploaded"] > 0 and moved["fetched"] > 0 and moved["waits"] > 0
    counts = collections.Counter(transfer.COUNTS)
    with profiling.tracing() as spans:
        assert sharded.sharded_gzip_decompress(arch, device="cuda") == x
    assert {"decode.plan", "decode.expand", "transfer.wait"} <= {s.name for s in spans}
    moved = collections.Counter(transfer.COUNTS) - counts
    assert moved["uploaded"] > 0 and moved["fetched"] > 0 and moved["waits"] > 0
