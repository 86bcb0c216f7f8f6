"""CUDA kernels == their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
False (decided inside the fixture, so every worker collects the same
tests).  This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Random and extreme inputs, odd shapes (P below one 1024-position chunk,
batches of 1 and 9 rows, strided payload rows, matches running into the
row end, with and without the hot lane); exact equality (integer
kernels), slot values compared under their n-bit masks; gzip on the card
at levels 1, 4, 6 and 9 equal to the CPU port.
"""

import gzip
import pathlib

import numpy as np
import pytest
import torch

from decompress_tpu_torch import gz
from decompress_tpu_torch.ops import cost_cu, hist_cu, pack_cu, parse_cu

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


@pytest.mark.parametrize("p,seg_len,b", [(2, 2, 1), (128, 100, 2), (2048, 2000, 3),
                                         (1 << 17, 130560, 3)])
def test_mark_path_kernel(dev, p, seg_len, b):
    g = torch.from_numpy(_jumps(np.random.default_rng(p), b, p, seg_len)).to(dev)
    before = parse_cu.mark_path.launches
    got = parse_cu.mark_path(g)
    torch.cuda.synchronize()
    assert parse_cu.mark_path.launches == before + 1
    assert torch.equal(got, parse_cu.mark_path_plain(g))


@pytest.mark.parametrize("step", [1, 258])
def test_mark_path_kernel_extremes(dev, step):
    p = 1 << 15
    g = torch.clamp(torch.arange(p, device=dev, dtype=torch.int32) + step, max=p)
    got = parse_cu.mark_path(g.expand(2, p).contiguous())
    assert got.sum().item() == 2 * len(range(0, p, step))
    assert torch.equal(got, parse_cu.mark_path_plain(g.expand(2, p)))


def _parse_arrays(rng, b, t, dev):
    on_path = rng.random((b, t)) < 0.5
    is_match = on_path & (rng.random((b, t)) < 0.5)
    length = np.where(is_match, rng.integers(3, 259, (b, t)), 0).astype(np.int32)
    dist = np.where(is_match, rng.integers(1, 32769, (b, t)), 0).astype(np.int32)
    batch = rng.integers(0, 256, (b, 64 + t), dtype=np.uint8)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (on_path, is_match, length, dist, batch))


@pytest.mark.parametrize("b,t", [(1, 300), (9, 5000), (8, 130560)])
def test_histograms_kernel(dev, b, t):
    on_path, is_match, length, dist, batch = _parse_arrays(
        np.random.default_rng(t), b, t, dev)
    lit = batch[:, 64:]  # strided rows, as the payload of a batch
    got = hist_cu.histograms(on_path, is_match, length, dist, lit)
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


@pytest.mark.parametrize("b,t", [(1, 300), (9, 5000), (8, 130560)])
def test_litbits_kernel(dev, b, t):
    rng = np.random.default_rng(t + 2)
    batch = torch.from_numpy(rng.integers(0, 256, (b, 64 + t), dtype=np.uint8)).to(dev)
    lcost = torch.from_numpy(rng.integers(1, 16, (b, 286)).astype(np.int32)).to(dev)
    before = cost_cu.litbits.launches
    got = cost_cu.litbits(batch[:, 64:], lcost)
    torch.cuda.synchronize()
    assert cost_cu.litbits.launches == before + 1
    assert torch.equal(got, cost_cu.litbits_plain(batch[:, 64:], lcost))


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
    before = cost_cu.gain.launches
    got = cost_cu.gain(length, dist, hl, hd, pref, lcost, dcost)
    torch.cuda.synchronize()
    assert cost_cu.gain.launches == before + 1
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
        cost_cu.litbits(z, torch.zeros((2, 286), dtype=torch.int32, device=dev))


@pytest.mark.parametrize("level", [1, 4, 6, 9])
def test_gzip_on_card_matches_cpu(dev, level):
    x = (CORPUS / "paper1").read_bytes()
    out = gz.compress(x, level=level, segment_size=4096, device="cuda")
    assert out == gz.compress(x, level=level, segment_size=4096, device="cpu")
    assert gzip.decompress(out) == x
