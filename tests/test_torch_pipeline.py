"""The fixed-Huffman device step and its pieces: the port
(``decompress_tpu_torch.ops``, plain PyTorch versions of the kernels on
the CPU) against the reference (``decompress_tpu.ops``, JAX on the CPU).

* ``lz77.analyze`` (round A made byte-exact) arrays equal the reference's
  at levels 1-9, and through its repair: a round A with overestimated
  candidates (on the trim-repair segment of ``tests/test_trim_repair.py``)
  takes the trim-and-reparse loop (one or two re-parses) or, where trims
  keep surfacing overestimates, the exact-extension re-run, at level 4 and
  at the two-round level 6; ``analyze2_start`` is round A;
* ``pack_bits_device`` and ``words_to_bytes`` on random values and bit
  counts, with and without elements past the last word;
* ``fixed_deflate_segments`` words and totals at B = 1, 2 and 8 with
  ``seg_len`` 1024 and 4096, with history and ``bfinal`` 0 rows, each row
  decoding with zlib to its payload.
"""

import pathlib
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decompress_tpu.ops import bitpack as ref_bitpack
from decompress_tpu.ops import lz77 as ref_lz77
from decompress_tpu.ops import pipeline as ref_pipeline
from decompress_tpu_torch.ops import bitpack, lz77, pipeline
from torch_threads import one_torch_thread  # noqa: F401

SEG = 4096
CORPUS = pathlib.Path(__file__).parent / "corpus"


def _np(res):
    return {k: np.array(v) for k, v in res.items()}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def _paper1_rows():
    raw = np.frombuffer((CORPUS / "paper1").read_bytes(), np.uint8)
    data = raw[: 2 * SEG].reshape(2, SEG).copy()
    return data, np.array([SEG, SEG - 300], np.int32), np.zeros(2, np.int32)


@pytest.mark.parametrize("level", range(1, 10))
def test_analyze_matches_reference(level):
    data, nv, hl = _paper1_rows()
    want = _np(ref_lz77.analyze(jnp.asarray(data), jnp.asarray(nv), jnp.asarray(hl),
                                level=level, seg_len=SEG, hist=0))
    args = (torch.from_numpy(data), torch.from_numpy(nv), torch.from_numpy(hl))
    _assert_same(lz77.analyze(*args, level=level, seg_len=SEG, hist=0), want)
    if level in (1, 6):
        start = lz77.analyze2_start(*args, level=level, seg_len=SEG, hist=0)
        _assert_same(start, _np(ref_lz77.analyze2_start(
            jnp.asarray(data), jnp.asarray(nv), jnp.asarray(hl), level=level,
            seg_len=SEG, hist=0)))


def _trim_segment():
    """The trim-repair segment of tests/test_trim_repair.py."""
    rng = np.random.default_rng(7)
    base = bytes(rng.integers(32, 96, 700, dtype=np.uint8))
    raw = (base + b"abcdefgh" * 40 + base[:500] + b"abcdefgi" * 40 + base) * 3
    return np.frombuffer(raw[:SEG], np.uint8).copy()[None, :], np.array([SEG], np.int32)


def _corrupt_one(res, data):
    """The first selected match of 16..199 bytes that ends before a
    mismatch, its candidate overestimated by 5 bytes."""
    cl, ln, dist = res["cand_length"].copy(), res["length"][0], res["dist"][0]
    s = next(int(s) for s in np.nonzero(res["is_match"][0])[0]
             if 16 <= ln[s] < 200 and s + ln[s] + 8 < SEG
             and data[0, s + ln[s]] != data[0, s + ln[s] - dist[s]])
    cl[0, s] += 5
    return cl


def _corrupt_long(res, data):
    """Candidates of 16..199 bytes that end before a mismatch,
    overestimated by 5 bytes."""
    cl, cd = res["cand_length"].copy(), res["cand_dist"]
    for s in np.nonzero((cl[0] >= 16) & (cl[0] < 200))[0]:
        e = s + cl[0, s]
        if e + 8 < SEG and data[0, e] != data[0, e - cd[0, s]]:
            cl[0, s] += 5
    return cl


def _corrupt_all(res, data):
    """Every candidate of at least MIN_MATCH overestimated by 5 bytes."""
    cl = res["cand_length"].copy()
    m = cl >= lz77.MIN_MATCH
    cl[m] = np.minimum(cl[m] + 5, lz77.MAX_MATCH)
    return cl


@pytest.mark.parametrize("corrupt,level,passes", [
    (_corrupt_one, 4, [False, True]),  # trim, one re-parse: exact
    (_corrupt_one, 6, [False, True]),
    (_corrupt_long, 6, [False, False, True]),  # a second trim
    (_corrupt_long, 4, [False] * 4 + [True]),  # the exact-extension re-run
    (_corrupt_all, 6, [False] * 4 + [True]),
], ids=["one-4", "one-6", "long-6", "long-4", "all-6"])
def test_analyze_repair_matches_reference(monkeypatch, corrupt, level, passes):
    """``analyze`` on an inexact round A (the trim segment's candidates
    overestimated, re-parsed into a round-A result): both packages'
    round A is replaced by that result, the exact-extension run is kept,
    and the repaired arrays must be equal; ``passes`` lists whether each
    round A, re-parse and exact-extension run of the port was exact."""
    data, nv = _trim_segment()
    hl = np.zeros(1, np.int32)
    jd, jn, jh = jnp.asarray(data), jnp.asarray(nv), jnp.asarray(hl)
    td, tn, th = torch.from_numpy(data), torch.from_numpy(nv), torch.from_numpy(hl)
    two_round = lz77.level_config(level).two_round
    res = _np(ref_lz77.lz77_analyze(jd, jn, jh, level=level, seg_len=SEG, hist=0))
    cl = corrupt(res, data)
    bad_ref = ref_lz77.lz77_reparse_greedy(
        jd, jnp.asarray(cl), jnp.asarray(res["cand_dist"]), jn, seg_len=SEG, hist=0,
        lazy=True, two_round=two_round)
    bad = lz77.lz77_reparse_greedy(td, torch.from_numpy(cl),
                                   torch.from_numpy(res["cand_dist"]), tn, seg_len=SEG,
                                   hist=0, lazy=True, two_round=two_round)
    _assert_same(bad, _np(bad_ref))

    def first_bad(orig, bad_res):
        def analyze(*args, force_exact=False, **kw):
            if force_exact:
                out = orig(*args, force_exact=True, **kw)
                seen.append(bool(out["exact"].all()))
                return out
            seen.append(bool(bad_res["exact"].all()))
            return bad_res
        return analyze

    seen = []
    reparse = lz77.lz77_reparse_greedy

    def counted(*args, **kw):
        out = reparse(*args, **kw)
        seen.append(bool(out["exact"].all()))
        return out

    monkeypatch.setattr(ref_lz77, "lz77_analyze", first_bad(ref_lz77.lz77_analyze, bad_ref))
    want = _np(ref_lz77.analyze(jd, jn, jh, level=level, seg_len=SEG, hist=0))
    seen.clear()
    monkeypatch.setattr(lz77, "lz77_analyze", first_bad(lz77.lz77_analyze, bad))
    monkeypatch.setattr(lz77, "lz77_reparse_greedy", counted)
    got = lz77.analyze(td, tn, th, level=level, seg_len=SEG, hist=0)
    assert want["exact"].all()
    assert seen == passes
    _assert_same(got, want)


@pytest.mark.parametrize("shape,out_words", [((3, 500), 600), ((2, 4, 300), 40),
                                             ((1, 1), 2)])
def test_pack_bits_device_matches_reference(shape, out_words):
    rng = np.random.default_rng(sum(shape))
    vals = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    nbits = rng.integers(0, 32, shape).astype(np.int32)
    nbits.reshape(-1)[::7] = 0
    want_w, want_t = (np.asarray(a) for a in ref_bitpack.pack_bits_device(
        jnp.asarray(vals), jnp.asarray(nbits), out_words))
    got_w, got_t = bitpack.pack_bits_device(torch.from_numpy(vals.astype(np.int64)),
                                            torch.from_numpy(nbits), out_words)
    assert got_w.dtype == torch.uint32 and got_t.dtype == torch.int32
    np.testing.assert_array_equal(got_w.numpy(), want_w)
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    flat_w = got_w.reshape(-1, out_words)
    for i, t in enumerate(got_t.reshape(-1).tolist()):
        t = min(t, 32 * out_words)
        assert bitpack.words_to_bytes(flat_w[i], t) == ref_bitpack.words_to_bytes(
            want_w.reshape(-1, out_words)[i], t)


def _fixed_batch(b, seg, hist_len, seed):
    raw = np.frombuffer(b"".join(p.read_bytes() for p in sorted(CORPUS.iterdir())), np.uint8)
    rng = np.random.default_rng(seed)
    data = np.zeros((b, lz77.HIST + seg), np.uint8)
    nv = np.zeros(b, np.int32)
    hl = np.zeros(b, np.int32)
    for i in range(b):
        st = int(rng.integers(lz77.HIST, raw.size - seg))
        n = seg - 97 * (i % 3)
        h = hist_len[i % len(hist_len)]
        data[i, lz77.HIST:lz77.HIST + n] = raw[st:st + n]
        data[i, lz77.HIST - h:lz77.HIST] = raw[st - h:st]
        nv[i], hl[i] = n, h
    bf = np.ones(b, np.int32)
    bf[1::2] = 0
    return data, nv, hl, bf


@pytest.mark.parametrize("b,seg,hist_len", [(1, 1024, [0]), (2, 4096, [300, 0]),
                                            (8, 1024, [0, 2000, 5])])
def test_fixed_deflate_segments_matches_reference(b, seg, hist_len):
    data, nv, hl, bf = _fixed_batch(b, seg, hist_len, b)
    want_w, want_t = (np.asarray(a) for a in ref_pipeline.fixed_deflate_segments(
        *(jnp.asarray(a) for a in (data, nv, hl, bf)), level=6, seg_len=seg))
    got_w, got_t = pipeline.fixed_deflate_segments(
        *(torch.from_numpy(a) for a in (data, nv, hl, bf)), level=6, seg_len=seg)
    assert got_w.shape == (b, (10 * seg) // 32 + 64) and got_w.dtype == torch.uint32
    np.testing.assert_array_equal(got_w.numpy(), want_w)
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    for i in range(b):
        body = bitpack.words_to_bytes(got_w[i], int(got_t[i]))
        assert body[0] & 1 == bf[i]  # BFINAL
        window = data[i, lz77.HIST - hl[i]:lz77.HIST].tobytes()
        d = zlib.decompressobj(-15, zdict=window) if hl[i] else zlib.decompressobj(-15)
        assert d.decompress(body) == data[i, lz77.HIST:lz77.HIST + nv[i]].tobytes()
        assert d.eof == bool(bf[i])
