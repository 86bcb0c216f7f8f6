"""Port's LZ77 analysis == the reference's, array for array.

Same numpy batches through ``decompress_tpu.ops.lz77`` (JAX on the CPU,
XLA mark path and histograms) and ``decompress_tpu_torch.ops.lz77`` (the
plain PyTorch versions of the kernels): every output array must be
equal, at levels 1 and 4 (short ladder) and 5, 6 and 9 (full ladder,
hash3 at 6 and 9, top2 at 9, ``dist_counts``), without and with 32 KiB
of history, with ``force_exact``, with a 1 KiB window, and through the
repair of corrupted candidates: the greedy trim-and-reparse loop, and at
level 6 the trim before round B, round B's retry loop and its
exact-extension fallback.  Round A on drawn inputs (hypothesis): corpus
slices with runs of one byte, periodic stretches of periods 1-4 and
mutated bytes near the row end, at levels 1-12 and windows 9-15.  The
copied constants are held equal to the reference's.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from hypothesis import HealthCheck, given, settings, strategies as st

from decompress_tpu.ops import cost_pl
from decompress_tpu.ops import lz77 as ref
from decompress_tpu_torch import de
from decompress_tpu_torch.ops import cost_cu, lz77, probe_cu
from torch_threads import one_torch_thread  # noqa: F401

SEG = 4096
CORPUS = pathlib.Path(__file__).parent / "corpus"


def _np_dict(res):
    return {k: np.array(v) for k, v in res.items()}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def _batch(hist):
    """3 segments of paper1 (the last short): with hist=HIST, as
    ``de.batch_rows`` builds them (history from the previous segment)."""
    raw = np.frombuffer((CORPUS / "paper1").read_bytes(), np.uint8)
    if hist:
        arr = raw[: 5 * SEG - 500]
        rows = de.batch_rows(*de._segments(arr, 2, 5, SEG), SEG)
        return rows.data[:3], rows.n_valid[:3], rows.hist_len[:3]
    data = raw[: 3 * SEG].reshape(3, SEG).copy()
    return data, np.array([SEG, SEG, SEG - 500], np.int32), np.zeros(3, np.int32)


def _both(data, n_valid, hist_len, **kw):
    want = ref.lz77_analyze(jnp.asarray(data), jnp.asarray(n_valid),
                            jnp.asarray(hist_len), seg_len=SEG, **kw)
    got = lz77.lz77_analyze(torch.from_numpy(data), torch.from_numpy(n_valid),
                            torch.from_numpy(hist_len), seg_len=SEG, **kw)
    return got, _np_dict(want)


@pytest.mark.parametrize("hist", [0, lz77.HIST])
@pytest.mark.parametrize("level", [1, 4, 5, 6, 9])
def test_analyze_matches_reference(level, hist):
    got, want = _both(*_batch(hist), level=level, hist=hist)
    assert want["exact"].all() and want["is_match"].any()
    _assert_same(got, want)


def test_analyze_force_exact_matches_reference():
    got, want = _both(*_batch(0), level=4, hist=0, force_exact=True)
    _assert_same(got, want)


def test_analyze_small_window_matches_reference():
    got, want = _both(*_batch(lz77.HIST), level=4, hist=lz77.HIST,
                      window_bits=10)
    assert want["dist"].max() <= 1 << 10
    _assert_same(got, want)


@pytest.mark.parametrize("level", [6, 9])
def test_analyze_full_ladder_force_exact_matches_reference(level):
    got, want = _both(*_batch(lz77.HIST), level=level, hist=lz77.HIST,
                      force_exact=True)
    _assert_same(got, want)


def test_analyze_full_ladder_small_window_matches_reference():
    got, want = _both(*_batch(lz77.HIST), level=6, hist=lz77.HIST,
                      window_bits=10)
    assert want["dist"].max() <= 1 << 10
    _assert_same(got, want)


DRAWN_SEG, DRAWN_HIST = 2048, 1024


@st.composite
def _drawn_round_a(draw):
    """(data, n_valid, hist_len, level, window_bits): two corpus slices of
    DRAWN_HIST + DRAWN_SEG bytes, each with up to 4 mutations (a run of
    one byte, a periodic stretch of period 1-4, bytes rewritten near the
    row end), drawn valid lengths and histories, a level and a window."""
    raw = np.frombuffer((CORPUS / "book1").read_bytes(), np.uint8)
    t = DRAWN_HIST + DRAWN_SEG
    data = np.zeros((2, t), np.uint8)
    for r in range(2):
        start = draw(st.integers(0, len(raw) - t))
        row = raw[start:start + t].copy()
        for _ in range(draw(st.integers(0, 4))):
            kind = draw(st.sampled_from(("run", "period", "tail")))
            at = draw(st.integers(0, t - 1))
            n = draw(st.integers(1, 600))
            if kind == "run":
                row[at:at + n] = draw(st.integers(0, 255))
            elif kind == "period":
                pattern = np.frombuffer(draw(st.binary(min_size=1, max_size=4)), np.uint8)
                row[at:at + n] = np.resize(pattern, len(row[at:at + n]))
            else:  # near the row end: fresh bytes or a copy of earlier text
                n = min(n, 300)
                src = draw(st.integers(0, t - n))
                row[t - n:] = (np.frombuffer(draw(st.binary(min_size=n, max_size=n)), np.uint8)
                               if draw(st.booleans()) else row[src:src + n].copy())
        data[r] = row
    n_valid = np.array([DRAWN_SEG, draw(st.integers(1, DRAWN_SEG))], np.int32)
    hist_len = np.array([draw(st.integers(0, DRAWN_HIST)) for _ in range(2)], np.int32)
    return data, n_valid, hist_len, draw(st.integers(1, 12)), draw(st.integers(9, 15))


@settings(deadline=None, max_examples=6, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])
@given(_drawn_round_a())
def test_analyze_drawn_inputs_match_reference(case):
    """Round A of drawn batches equals the reference's in every output.
    Each (level, window) costs the reference a compile (~3 s on the CPU),
    so the examples are few and fixed (derandomized)."""
    data, n_valid, hist_len, level, window_bits = case
    want = ref.lz77_analyze(jnp.asarray(data), jnp.asarray(n_valid), jnp.asarray(hist_len),
                            level=level, seg_len=DRAWN_SEG, window_bits=window_bits,
                            hist=DRAWN_HIST)
    got = lz77.lz77_analyze(torch.from_numpy(data), torch.from_numpy(n_valid),
                            torch.from_numpy(hist_len), level=level, seg_len=DRAWN_SEG,
                            window_bits=window_bits, hist=DRAWN_HIST)
    _assert_same(got, _np_dict(want))


def _trim_segment():
    """The trim-repair segment of tests/test_trim_repair.py."""
    rng = np.random.default_rng(7)
    base = bytes(rng.integers(32, 96, 700, dtype=np.uint8))
    raw = (base + b"abcdefgh" * 40 + base[:500] + b"abcdefgi" * 40 + base) * 3
    data = np.frombuffer(raw[:SEG], np.uint8).copy()[None, :]
    return data, np.array([SEG], np.int32)


def _round_a(data, n_valid, level):
    """The reference's round A of one segment without history."""
    return _np_dict(ref.lz77_analyze(jnp.asarray(data), jnp.asarray(n_valid),
                                     jnp.zeros(1, jnp.int32), level=level,
                                     seg_len=SEG, hist=0))


def _corrupted():
    """The trim-repair segment with one selected match's candidate
    overestimated by 5 bytes."""
    data, n_valid = _trim_segment()
    res = _round_a(data, n_valid, 4)
    ln, dist, cl = res["length"][0], res["dist"][0], res["cand_length"].copy()
    s = next(int(s) for s in np.nonzero(res["is_match"][0])[0]
             if 16 <= ln[s] < 200 and s + ln[s] + 8 < SEG
             and data[0, s + ln[s]] != data[0, s + ln[s] - dist[s]])
    cl[0, s] += 5
    return data, n_valid, cl, res["cand_dist"], s


def test_trim_and_reparse_match_reference():
    data, n_valid, cl, cd, s = _corrupted()
    jd, jn = jnp.asarray(data), jnp.asarray(n_valid)
    td, tn = torch.from_numpy(data), torch.from_numpy(n_valid)
    want_bad = _np_dict(ref.lz77_reparse_greedy(
        jd, jnp.asarray(cl), jnp.asarray(cd), jn, seg_len=SEG, hist=0, lazy=True))
    got_bad = lz77.lz77_reparse_greedy(td, torch.from_numpy(cl),
                                       torch.from_numpy(cd), tn, seg_len=SEG,
                                       hist=0, lazy=True)
    assert not want_bad["exact"].all() and want_bad["is_match"][0, s]
    _assert_same(got_bad, want_bad)

    want_cl = np.asarray(ref.lz77_trim_candidates(
        jd, *(jnp.asarray(want_bad[k]) for k in ("is_match", "length", "dist")),
        jnp.asarray(cl), jnp.asarray(cd), jn, seg_len=SEG, hist=0))
    got_cl = lz77.lz77_trim_candidates(
        td, got_bad["is_match"], got_bad["length"], got_bad["dist"],
        torch.from_numpy(cl), torch.from_numpy(cd), tn, seg_len=SEG, hist=0)
    np.testing.assert_array_equal(got_cl.numpy(), want_cl)
    assert want_cl[0, s] == cl[0, s] - 5

    # the whole repair loop on the corrupted round-A result
    hl = np.zeros(1, np.int32)
    want = _np_dict(ref.analyze2_finish(
        {k: jnp.asarray(v) for k, v in want_bad.items()}, jd, jn,
        jnp.asarray(hl), level=4, seg_len=SEG, hist=0))
    got = lz77.analyze2_finish(got_bad, td, tn, torch.from_numpy(hl), level=4,
                               seg_len=SEG, hist=0)
    assert want["exact"].all()
    _assert_same(got, want)


def _corrupt_all(cl, data, cd):
    """Every candidate of at least MIN_MATCH overestimated by 5 bytes."""
    cl = cl.copy()
    m = cl >= lz77.MIN_MATCH
    cl[m] = np.minimum(cl[m] + 5, lz77.MAX_MATCH)
    return cl


def _corrupt_long(cl, data, cd):
    """Candidates of 16..199 bytes that end before a mismatch,
    overestimated by 5 bytes."""
    cl = cl.copy()
    for s in np.nonzero((cl[0] >= 16) & (cl[0] < 200))[0]:
        e = s + cl[0, s]
        if e + 8 < SEG and data[0, e] != data[0, e - cd[0, s]]:
            cl[0, s] += 5
    return cl


@pytest.mark.parametrize("corrupt,passes", [
    (_corrupt_long, [False, True]),  # trim, one retry, exact
    (_corrupt_all, [False, False, False, True]),  # exact-extension fallback
], ids=["retry", "exact_fallback"])
def test_round_b_repair_matches_reference(monkeypatch, corrupt, passes):
    """analyze2_finish at level 6 on an inexact round A (corrupted
    candidates re-parsed by lz77_reparse_greedy with two_round): the
    trim before round B, round B's trim-and-retry loop and, when three
    passes stay inexact, the exact-extension round A with its final
    unchecked round B; ``passes`` lists whether each round-B pass of the
    port was exact."""
    data, n_valid = _trim_segment()
    res = _round_a(data, n_valid, 6)
    cd = res["cand_dist"]
    cl = corrupt(res["cand_length"], data, cd)
    jd, jn = jnp.asarray(data), jnp.asarray(n_valid)
    td, tn = torch.from_numpy(data), torch.from_numpy(n_valid)
    want_bad = _np_dict(ref.lz77_reparse_greedy(
        jd, jnp.asarray(cl), jnp.asarray(cd), jn, seg_len=SEG, hist=0,
        lazy=True, two_round=True))
    got_bad = lz77.lz77_reparse_greedy(td, torch.from_numpy(cl),
                                       torch.from_numpy(cd), tn, seg_len=SEG,
                                       hist=0, lazy=True, two_round=True)
    assert not want_bad["exact"].all()
    _assert_same(got_bad, want_bad)

    seen = []
    parse_cost = lz77.lz77_parse_cost

    def counted(*args, **kw):
        out = parse_cost(*args, **kw)
        seen.append(bool(out["exact"].all()))
        return out

    monkeypatch.setattr(lz77, "lz77_parse_cost", counted)
    hl = np.zeros(1, np.int32)
    want = _np_dict(ref.analyze2_finish(
        {k: jnp.asarray(v) for k, v in want_bad.items()}, jd, jn,
        jnp.asarray(hl), level=6, seg_len=SEG, hist=0))
    got = lz77.analyze2_finish(got_bad, td, tn, torch.from_numpy(hl), level=6,
                               seg_len=SEG, hist=0)
    assert seen == passes
    assert want["exact"].all()
    _assert_same(got, want)


def test_constants_match_reference():
    for name in ("HIST", "MIN_MATCH", "MAX_MATCH", "TOO_FAR", "_TRIM_RETRIES",
                 "HOT_DIST_BINS", "HOT_DISTS"):
        assert getattr(lz77, name) == getattr(ref, name), name
    for name in ("HASH_BITS", "_FP_SPANS"):  # the record build's, in probe_cu
        assert getattr(probe_cu, name) == getattr(ref, name), name
    assert [f.name for f in dataclasses.fields(lz77.LevelConfig)] == \
        [f.name for f in dataclasses.fields(ref.LevelConfig)]
    assert set(lz77.LEVELS) == set(ref.LEVELS)
    for level, cfg in ref.LEVELS.items():
        assert dataclasses.asdict(lz77.LEVELS[level]) == dataclasses.asdict(cfg)
        assert lz77.level_config(level) == lz77.LEVELS[level]
    assert cost_cu.NEG_GAIN == cost_pl.NEG_GAIN
    for level in (0, 13, 99, -1):
        with pytest.raises(ValueError, match="unknown level"):
            lz77.level_config(level)


def test_hash_and_fingerprints_match_reference():
    """Words, the premultiplied fingerprint pyramid (both multipliers and
    the rotate) and the combine on random and adversarial bytes."""
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, (2, 777), dtype=np.uint8)
    x[1, 100:400] = 0xFF
    w = probe_cu._u32_words(torch.from_numpy(x))
    fp = probe_cu._fingerprints(w)
    for i in range(2):
        wr = ref._u32_words(jnp.asarray(x[i]))
        np.testing.assert_array_equal(w[i].numpy(), np.asarray(wr))
        fr = ref._fingerprints(wr)
        for span in ref._FP_SPANS:
            np.testing.assert_array_equal(fp[span][i].numpy(), np.asarray(fr[span]))
    a, b = (rng.integers(0, 1 << 32, 1000, dtype=np.uint64) for _ in range(2))
    got = probe_cu._mix(torch.from_numpy(a.astype(np.int64)),
                    torch.from_numpy(b.astype(np.int64)))
    want = ref._mix(jnp.asarray(a.astype(np.uint32)), jnp.asarray(b.astype(np.uint32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_run_lengths_match_reference():
    rng = np.random.default_rng(2)
    eqs = rng.random((4, 3000)) < 0.9
    eqs[2] = True
    got = lz77._run_lengths(torch.from_numpy(eqs))
    want = jax.jit(ref._run_length_scan_multi)(jnp.asarray(eqs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_state_round_trip():
    res = {"on_path": np.array([[True, False]]),
           "length": np.array([[0, 7]], np.int32)}
    st = lz77.state_from_numpy(res, "cpu")
    assert st["on_path"].dtype == torch.bool and st["length"].dtype == torch.int32
    back = lz77.state_to_numpy(st)
    for k in res:
        np.testing.assert_array_equal(back[k], res[k])
