"""Port's round-B cost kernels and cost-aware re-parse == the reference's.

The plain versions of the literal-bits and gain kernels (which the
``cost_cu`` wrappers take for CPU tensors) are held against
``cost_pl.litbits_pl`` and ``cost_pl.gain_pl`` in interpret mode, and
the literal bits' prefix sum against the reference's ``_pref_slab``; the
port's int32 ``lz77_parse_cost`` against the reference's (its XLA
float32 branch on the CPU), array for array, without and with history,
hot-stride mining and a 1 KiB window; the copied host helpers
(``_cost_tables_host``, ``_hot_dists_host``) against the reference's.
All comparisons are exact: the pipeline is integer end to end.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from decompress_tpu.ops import cost_pl
from decompress_tpu.ops import lz77 as ref
from decompress_tpu_torch import de
from decompress_tpu_torch.ops import cost_cu, lz77

SEG = 8192
T = 1024


def _costs(rng, b, hi=15):
    return (rng.integers(1, hi + 1, (b, 286)).astype(np.int32),
            rng.integers(1, hi + 1, (b, 30)).astype(np.int32))


@pytest.mark.parametrize("b", [1, 2])
def test_litbits_matches_pallas_kernel(b):
    rng = np.random.default_rng(b)
    batch = rng.integers(0, 256, (b, 40 + T), dtype=np.uint8)
    lcost, _ = _costs(rng, b)
    lit = torch.from_numpy(batch)[:, 40:]  # strided rows, as a batch payload
    got = cost_cu.litbits_pref(lit, torch.from_numpy(lcost))[0]
    want = cost_pl.litbits_pl(jnp.asarray(batch[:, 40:].astype(np.int32)),
                              jnp.asarray(lcost), interpret=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("b", [1, 2])
def test_litbits_pref_matches_reference(b, strided):
    """Both outputs of litbits_pref: the bits against the Pallas kernel,
    the prefix against the reference's own, read back from the per-row
    512-wide slabs ``cost_pl._pref_slab`` builds of the same bits (row r
    of a segment holds pref[r * 128 + j] at column j, so columns 0-127
    of its rows are pref[:T] and its last row's column 128 is pref[T])."""
    rng = np.random.default_rng(20 + b)
    off = 40 if strided else 0
    batch = rng.integers(0, 256, (b, off + T), dtype=np.uint8)
    lcost, _ = _costs(rng, b)
    bits, pref = cost_cu.litbits_pref(torch.from_numpy(batch)[:, off:],
                                      torch.from_numpy(lcost))
    assert bits.dtype == pref.dtype == torch.int32
    assert pref.shape == (b, T + 1)
    want = np.asarray(cost_pl.litbits_pl(
        jnp.asarray(batch[:, off:].astype(np.int32)), jnp.asarray(lcost),
        interpret=True))
    np.testing.assert_array_equal(bits.numpy(), want)
    rps, rp_pad, _, _ = cost_pl._grids(b, T)
    slab = np.asarray(cost_pl._pref_slab(jnp.asarray(want))).reshape(
        b, rp_pad, cost_pl.SLAB_W)
    np.testing.assert_array_equal(pref[:, :T].numpy(),
                                  slab[:, :rps, :cost_pl.LANES].reshape(b, T))
    np.testing.assert_array_equal(pref[:, T].numpy(),
                                  slab[:, rps - 1, cost_pl.LANES])
    assert (pref[:, 0] == 0).all()


def _gain_inputs(rng, b, hot: bool):
    lit = rng.integers(0, 256, (b, T)).astype(np.int32)
    lcost, dcost = _costs(rng, b)
    lb = np.take_along_axis(lcost, lit, axis=1)
    pref = np.concatenate([np.zeros((b, 1), np.int32),
                           np.cumsum(lb, axis=1, dtype=np.int32)], axis=1)
    ln = rng.integers(0, 259, (b, T)).astype(np.int32)
    ln[:, -300:] = 258  # matches running into the row end
    dist = rng.integers(1, 32769, (b, T)).astype(np.int32)
    hl = hd = None
    if hot:
        hl = rng.integers(0, 259, (b, T)).astype(np.int32)
        hd = rng.integers(1, 32769, (b, T)).astype(np.int32)
        ln[:, :20] = hl[:, :20] = 2  # no match in either lane
    return ln, dist, hl, hd, lb, pref, lcost, dcost


@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("b", [1, 2])
def test_gain_matches_pallas_kernel(b, hot):
    ln, dist, hl, hd, lb, pref, lcost, dcost = _gain_inputs(
        np.random.default_rng(10 * b + hot), b, hot)
    want = cost_pl.gain_pl(
        jnp.asarray(ln), jnp.asarray(dist),
        None if hl is None else jnp.asarray(hl),
        None if hd is None else jnp.asarray(hd),
        cost_pl._pref_slab(jnp.asarray(lb)), jnp.asarray(lcost),
        jnp.asarray(dcost), interpret=True)

    def t(a):
        return None if a is None else torch.from_numpy(a)

    got = cost_cu.gain(t(ln), t(dist), t(hl), t(hd), t(pref), t(lcost),
                       t(dcost))
    for g, w, name in zip(got, want, ("length", "dist", "gain")):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    gain = got[2].numpy()
    assert (gain == cost_cu.NEG_GAIN).any() and (gain > 0).any()
    if hot:  # the hot lane wins at some positions and loses at others
        took = got[0].numpy() != ln
        assert took.any() and not took.all()


def _strided(rng, strides, n):
    """Periodic rows of random bytes with 6% noise, one period per piece
    (image-like data: mining finds the periods)."""
    out = []
    for d in strides:
        row = rng.integers(0, 256, d, dtype=np.uint8)
        piece = np.tile(row, n // len(strides) // d + 2)[: n // len(strides)]
        flip = rng.random(piece.size) < 0.06
        piece[flip] = rng.integers(0, 256, int(flip.sum()), dtype=np.uint8)
        out.append(piece)
    return np.resize(np.concatenate(out), n)


def _text(rng, n):
    """Compressible text-ish bytes (tests/test_cost_pl.py's generator)."""
    words = rng.integers(97, 123, size=64, dtype=np.uint8)
    chunks = []
    while sum(len(c) for c in chunks) < n:
        chunks.append(np.tile(words[rng.integers(0, 64, 8)], rng.integers(1, 6)))
    return np.concatenate(chunks)[:n]


def _batch(hist: int, strided: bool):
    rng = np.random.default_rng(5)
    if strided:
        rows = [_strided(rng, (37, 216, 555, 2000), hist + SEG),
                _strided(rng, (100, 300, 13, 1000), hist + SEG)]
    else:
        rows = [_text(rng, hist + SEG) for _ in range(2)]
    data = np.stack(rows)
    n_valid = np.array([SEG, SEG - 173], np.int32)
    hist_len = np.array([hist, max(hist - 5000, 0)], np.int32)
    return data, n_valid, hist_len


def _round_a(data, n_valid, hist_len, hist):
    """The reference's level-6 round A, as numpy arrays."""
    res = ref.lz77_analyze(jnp.asarray(data), jnp.asarray(n_valid),
                           jnp.asarray(hist_len), level=6, seg_len=SEG,
                           hist=hist)
    return {k: np.array(v) for k, v in res.items()}


def _parse_both(data, n_valid, hist_len, hist, mine, window_bits=15,
                costs=None):
    """Round A by the reference, then round B by both; returns
    (port's dict, reference's dict, hot dists or None)."""
    jd, jn, jh = (jnp.asarray(a) for a in (data, n_valid, hist_len))
    res = _round_a(data, n_valid, hist_len, hist)
    lc, dc = costs or ref._cost_tables_host(res["hist_lit"], res["hist_dist"])
    hot = ref._hot_dists_host(res["dist_counts"]) if mine else None
    kw = dict(seg_len=SEG, hist=hist, lazy=True, window_bits=window_bits)
    want = ref.lz77_parse_cost(
        jd, jnp.asarray(res["cand_length"]), jnp.asarray(res["cand_dist"]), jn,
        jnp.asarray(lc), jnp.asarray(dc), jh,
        None if hot is None else jnp.asarray(hot), **kw)
    got = lz77.lz77_parse_cost(
        torch.from_numpy(data), torch.from_numpy(res["cand_length"]),
        torch.from_numpy(res["cand_dist"]), torch.from_numpy(n_valid),
        torch.from_numpy(lc), torch.from_numpy(dc), torch.from_numpy(hist_len),
        None if hot is None else torch.from_numpy(hot), **kw)
    return got, {k: np.asarray(v) for k, v in want.items()}, hot


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("mine", [False, True])
@pytest.mark.parametrize("hist", [0, lz77.HIST])
def test_parse_cost_matches_reference(hist, mine):
    data, n_valid, hist_len = _batch(hist, strided=mine)
    got, want, hot = _parse_both(data, n_valid, hist_len, hist, mine)
    assert want["exact"].all() and want["is_match"].any()
    if mine:
        assert hot.any()
    _assert_same(got, want)


def test_parse_cost_small_window_matches_reference():
    """window_bits=10: candidates and the mined 2000-byte stride beyond
    the window are dropped."""
    data, n_valid, hist_len = _batch(lz77.HIST, strided=True)
    got, want, hot = _parse_both(data, n_valid, hist_len, lz77.HIST, True,
                                 window_bits=10)
    assert (hot > 1 << 10).any()
    assert want["dist"].max() <= 1 << 10
    _assert_same(got, want)


def test_parse_cost_zero_gain_boundary_matches_reference():
    """Cost tables of 1-3 bits make many gains exactly 0 (never taken:
    take needs gain > 0) and many negative; the int32 parse still
    equals the float32 one."""
    data, n_valid, hist_len = _batch(0, strided=False)
    rng = np.random.default_rng(3)
    lc, dc = (c.astype(np.float32) for c in _costs(rng, 2, hi=3))
    got, want, _ = _parse_both(data, n_valid, hist_len, 0, False,
                               costs=(lc, dc))
    _assert_same(got, want)
    # gains of exactly 0 do occur on these inputs
    res = _round_a(data, n_valid, hist_len, 0)
    lcost = torch.from_numpy(lc.astype(np.int32))
    _, pref = cost_cu.litbits_pref(torch.from_numpy(data), lcost)
    _, _, gain = cost_cu.gain(torch.from_numpy(res["cand_length"]),
                              torch.from_numpy(res["cand_dist"]),
                              None, None, pref, lcost,
                              torch.from_numpy(dc.astype(np.int32)))
    assert (gain == 0).any() and (gain < 0).any()


def test_cost_tables_are_small_integers():
    """What makes the int32 round B equal the reference's float32 one:
    every cost is an integer of at most 15 bits, so a segment's
    literal-bit prefix stays below 2^24 (exact in float32) and far from
    NEG_GAIN."""
    rng = np.random.default_rng(4)
    hist_lit = rng.integers(0, 5000, (6, 286)).astype(np.int32)
    hist_lit[:, rng.random(286) < 0.3] = 0
    hist_lit[0] = 0
    hist_dist = rng.integers(0, 500, (6, 30)).astype(np.int32)
    hist_dist[1] = 0
    for tab in lz77._cost_tables_host(hist_lit, hist_dist):
        assert (tab == np.round(tab)).all()
        assert tab.min() >= 1 and tab.max() <= 15
    assert de.SEGMENT_SIZE * 15 < 1 << 24
    # a real gain is >= -(lit/len code + 5 extra + dist code + 13 extra)
    # bits; the sentinel minus a literal's bits stays below it, in int32
    assert -(1 << 31) < cost_cu.NEG_GAIN - 15 < -(15 + 5 + 15 + 13)


def test_host_helpers_match_reference():
    """The copied host helpers on random histograms with tied counts
    (which tied count np.argpartition keeps decides the mined
    distances, so the copy must be verbatim)."""
    rng = np.random.default_rng(6)
    counts = rng.integers(0, 80, (8, lz77.HOT_DIST_BINS)).astype(np.int32)
    counts[1] = 70  # every bin tied
    counts[2, :] = 0
    counts[2, 100:120] = 64  # 20 tied at the threshold
    counts[3, 50:60] = 500  # ties above the threshold, small d too
    counts[3, 1:5] = 9999
    np.testing.assert_array_equal(lz77._hot_dists_host(counts),
                                  ref._hot_dists_host(counts))
    hist_lit = rng.integers(0, 3, (8, 286)).astype(np.int32)  # many ties
    hist_dist = rng.integers(0, 3, (8, 30)).astype(np.int32)
    hist_lit[0] = 0
    hist_dist[0] = 0
    for g, w in zip(lz77._cost_tables_host(hist_lit, hist_dist),
                    ref._cost_tables_host(hist_lit, hist_dist)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
