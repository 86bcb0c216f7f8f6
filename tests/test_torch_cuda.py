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
1-100 bits, rows outside the body), the CRC kernel on chunks of member
batches at lengths around the 256-byte chunk, and the sharded round trip
on the card.
"""

import functools
import gzip
import pathlib
import zlib

import numpy as np
import pytest
import torch

from decompress_tpu_torch import _build, gz
from decompress_tpu_torch.ops import (checksum, cost_cu, crc_cu, hist_cu, inflate,
                                      inflate_cu, pack_cu, parse_cu)
from decompress_tpu_torch.parallel import sharded

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
    return sharded.decode_plan(buf)


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
    rng = np.random.default_rng(width)
    lengths = np.array([0, 1, 255, 256, 257, width])
    data = np.zeros((lengths.size, width), np.uint8)
    for i, n in enumerate(lengths):
        data[i, :n] = rng.integers(0, 256, n, dtype=np.uint8)
    chunks = torch.from_numpy(data).to(dev)[:, : width // 256 * 256].reshape(-1, 256)
    before = _build.LAUNCHES["chunk_registers"]
    got = crc_cu.chunk_registers(chunks.contiguous())
    torch.cuda.synchronize()
    assert _build.LAUNCHES["chunk_registers"] == before + 1
    assert torch.equal(got, crc_cu.chunk_registers_plain(chunks))
    crcs = checksum.crc32_batch_device(torch.from_numpy(data).to(dev), lengths)
    assert crcs.tolist() == [zlib.crc32(data[i, :n].tobytes()) for i, n in enumerate(lengths)]


def test_sharded_round_trip_on_card(dev):
    sharded.serial_fallbacks.clear()
    x = (CORPUS / "book1").read_bytes()[:200_000] + bytes(50_000)
    arch = sharded.sharded_gzip_compress(x, member_size=65536, device="cuda")
    assert arch == sharded.sharded_gzip_compress(x, member_size=65536, device="cpu")
    assert gzip.decompress(arch) == x
    assert sharded.sharded_gzip_decompress(arch, device="cuda") == x
    assert not sharded.serial_fallbacks
