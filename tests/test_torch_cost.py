"""Port's round-B cost kernels and cost-aware re-parse == the reference's.

The plain versions of the literal-bits and gain kernels (which the
``cost_cu`` wrappers take for CPU tensors) are held against
``cost_pl.litbits_pl`` and ``cost_pl.gain_pl`` in interpret mode, and
the literal bits' prefix sum against the reference's ``_pref_slab``; the
port's int32 ``lz77_parse_cost`` against the reference's (its XLA
float32 branch on the CPU), array for array, without and with history,
hot-stride mining and a 1 KiB window; the copied host helpers
(``_cost_tables_host``, ``_hot_dists_host``) against the reference's.
The native cost tables (``native/plan.cpp``) equal the reference's
Python tables on drawn batches, whole level-6 streams and archives are
the same with either, and
``lz77.TABLE_COUNTS`` counts rows and redistributed trees.  All
comparisons are exact: the pipeline is integer end to end.
"""

import collections
import gzip
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from decompress_tpu.ops import cost_pl
from decompress_tpu.ops import lz77 as ref
from decompress_tpu_torch import de, gz
from decompress_tpu_torch.core import huffman
from decompress_tpu_torch.ops import cost_cu, lz77
from decompress_tpu_torch.parallel import sharded

CORPUS = pathlib.Path(__file__).parent / "corpus"

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


def _fib(n: int) -> np.ndarray:
    """1, 2, 3, 5, ...: a Huffman chain n - 1 deep."""
    f = [1, 2]
    while len(f) < n:
        f.append(f[-1] + f[-2])
    return np.array(f[:n], np.int64)


def _overflows(hl, hd) -> bool:
    """Whether a row's literal (one EOB added) or distance tree is deeper
    than 15 bits, so that its lengths are redistributed."""
    h = hl.astype(np.int64)
    h[256] += 1
    return any(not np.array_equal(huffman.code_lengths_from_frequencies(f, 15),
                                  huffman.code_lengths_from_frequencies(f, 40))
               for f in (h, hd.astype(np.int64)))


def _deep_rows(rng, b):
    """Rows whose trees are forced past 15 bits: Fibonacci counts over
    20-30 random symbols of the literals (row 0 of every three), the
    distances (row 1) or both (row 2)."""
    hl = rng.integers(0, 50, (b, 286))
    hd = rng.integers(0, 20, (b, 30))
    for i in range(b):
        which = i % 3
        if which != 1:
            k = int(rng.integers(20, 31))
            hl[i] = 0
            hl[i, rng.choice(286, k, replace=False)] = _fib(k)
        if which != 0:
            hd[i] = _fib(30)[rng.permutation(30)]
    return hl, hd


def _edge_rows(rng, b):
    """All-zero rows, one symbol, EOB alone, symbol 0 alone, one distance."""
    hl = np.zeros((b, 286), np.int64)
    hd = np.zeros((b, 30), np.int64)
    for i in range(b):
        kind = rng.integers(0, 5)
        if kind == 1:
            hl[i, rng.integers(0, 286)] = rng.integers(1, 1000)
            hd[i, rng.integers(0, 30)] = rng.integers(1, 1000)
        elif kind == 2:
            hl[i, 256] = rng.integers(1, 5)
        elif kind == 3:
            hl[i, 0] = rng.integers(1, 5)
            hd[i, 0] = rng.integers(1, 5)
        elif kind == 4:
            hd[i, rng.integers(0, 30)] = 1
    return hl, hd


#: batch kind -> rows drawn from (rng, b)
_DRAWS = {
    "dense": lambda rng, b: (rng.integers(0, 5000, (b, 286)),
                             rng.integers(0, 500, (b, 30))),
    "sparse": lambda rng, b: (rng.integers(0, 5000, (b, 286)) * (rng.random((b, 286)) < 0.15),
                              rng.integers(0, 500, (b, 30)) * (rng.random((b, 30)) < 0.3)),
    "heavy_tail": lambda rng, b: (rng.zipf(1.3, (b, 286)) - 1, rng.zipf(1.5, (b, 30)) - 1),
    "ties": lambda rng, b: (rng.integers(0, 3, (b, 286)), rng.integers(0, 3, (b, 30))),
    "edge": _edge_rows,
    "deep": _deep_rows,
}


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("kind", sorted(_DRAWS))
def test_native_cost_tables_equal_reference(kind, dtype):
    """Forty seeded batches of 1-8 rows a kind and dtype (480 in all):
    the native tables equal the reference's in dtype, shape and every
    entry."""
    rng = np.random.default_rng([sorted(_DRAWS).index(kind), np.dtype(dtype).itemsize])
    for _ in range(40):
        hl, hd = _DRAWS[kind](rng, int(rng.integers(1, 9)))
        hl, hd = hl.astype(dtype), hd.astype(dtype)
        got = lz77._cost_tables_host(hl, hd)
        for g, w in zip(got, ref._cost_tables_host(hl, hd)):
            assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_table_counts_count_rows_and_overflow():
    rng = np.random.default_rng(7)
    hl, hd = _deep_rows(rng, 5)
    hl2, hd2 = _DRAWS["ties"](rng, 3)
    hl, hd = np.concatenate([hl, hl2]), np.concatenate([hd, hd2])
    overflow = sum(_overflows(a, d) for a, d in zip(hl, hd))
    assert overflow == 5
    before = collections.Counter(lz77.TABLE_COUNTS)
    lz77._cost_tables_host(hl, hd)
    got = {k: lz77.TABLE_COUNTS[k] - before[k] for k in ("rows", "overflow")}
    assert got == {"rows": 8, "overflow": overflow}


def test_cost_tables_refuse_other_widths():
    with pytest.raises(ValueError, match="histograms"):
        lz77._cost_tables_host(np.zeros((2, 285), np.int32), np.zeros((2, 30), np.int32))


def test_whole_streams_equal_with_the_reference_tables(monkeypatch):
    """A 36,000-byte Calgary prefix at level 6 in 4 KiB segments (two
    batches): the gzip stream and the indexed archive are the same bytes
    with the native tables as with the reference's."""
    x = (CORPUS / "paper1").read_bytes()[:36_000]

    def both():
        return (gz.compress(x, 6, segment_size=4096, device="cpu"),
                sharded.sharded_gzip_compress(x, 6, member_size=4096, device="cpu"))

    before = collections.Counter(lz77.TABLE_COUNTS)
    native = both()
    assert (lz77.TABLE_COUNTS - before)["rows"] >= 18
    monkeypatch.setattr(lz77, "_cost_tables_host", ref._cost_tables_host)
    assert native == both()
    assert gzip.decompress(native[0]) == x
    assert gzip.decompress(native[1]) == x
