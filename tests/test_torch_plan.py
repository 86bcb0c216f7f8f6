"""The native block planner (``native/plan.cpp``) against the reference's.

``de.plan_blocks`` plans a batch in one native call;
``decompress_tpu.de.plan_blocks`` is the reference's Python planner, its
model.  The two must agree byte for byte: the kinds, and every
output array's dtype, shape and values, on rows with no symbols or one,
on counts that push the literal and distance trees past 15 bits and the
precode past 7, under every ``force_block`` and both forms of
``shared_tree``, for batches of 1 and 8 rows padded further, and on rows
too short for anything but a stored block.  A whole gzip stream made with
each planner is the same, and ``de.PLAN_COUNTS`` counts a batch's kinds
and its redistributed trees.
"""

import collections
import gzip

import numpy as np
import pytest

from decompress_tpu import de as ref_de
from decompress_tpu_torch import de, gz
from decompress_tpu_torch.core import huffman, tables

from torch_threads import one_torch_thread  # noqa: F401

NL, ND = tables.NUM_LIT_SYMS, tables.NUM_DIST_SYMS


def _fib(n: int) -> np.ndarray:
    """1, 2, 3, 5, ...: a Huffman chain n - 1 deep."""
    f = [1, 2]
    while len(f) < n:
        f.append(f[-1] + f[-2])
    return np.array(f[:n], np.int64)


def _redistributed(freqs, max_length: int) -> bool:
    """Whether ``freqs``' Huffman tree is deeper than ``max_length``."""
    return not np.array_equal(huffman.code_lengths_from_frequencies(freqs, max_length),
                              huffman.code_lengths_from_frequencies(freqs, 40))


def _planned(hl, hd):
    """A row's literal counts as planned (one EOB added) and distance counts."""
    h = hl.astype(np.int64)
    h[de.EOB] += 1
    return h, hd.astype(np.int64)


def _precode_freqs(hl, hd):
    lit, dist = (huffman.code_lengths_from_frequencies(f) for f in _planned(hl, hd))
    hlit = max(257, int(np.flatnonzero(lit)[-1]) + 1)
    nz = np.flatnonzero(dist)
    hdist = int(nz[-1]) + 1 if nz.size else 1
    rle = de._rle_code_lengths(np.concatenate([lit[:hlit], dist[:hdist]]))
    return np.bincount([sym for sym, _, _ in rle], minlength=19)


def _deep_precode_row(rng):
    """A row whose code lengths RLE into a precode deeper than 7 bits:
    a complete set of dyadic counts (2^(15 - length) for lengths split at
    random from the chain 1, 2, ..., 15, 15) at random symbols."""
    while True:
        lens = list(range(1, 16)) + [15]
        while len(lens) < 115:
            deep = [i for i, n in enumerate(lens) if n < 15]
            w = np.array([lens[i] for i in deep], float) ** 7.6
            n = lens.pop(deep[rng.choice(len(deep), p=w / w.sum())])
            lens += [n + 1, n + 1]
        rng.shuffle(lens)
        pos = np.sort(rng.choice(257, len(lens), replace=False))
        pos[-1] = de.EOB
        hl = np.zeros(NL, np.int32)
        hl[pos] = [1 << (15 - n) for n in lens]
        hl[de.EOB] -= 1
        hd = np.full(ND, 7, np.int32)
        if _redistributed(_precode_freqs(hl, hd), 7):
            return hl, hd


def _random_rows(rng, b, skew=5000):
    hl = rng.integers(0, 50, (b, NL)).astype(np.int32)
    hd = rng.integers(0, 20, (b, ND)).astype(np.int32)
    hl[:, rng.integers(0, 256, 4)] += skew
    return hl, hd


def _tiny_rows(rng):
    hl = np.zeros((6, NL), np.int32)
    hd = np.zeros((6, ND), np.int32)
    hl[1, 97] = 5                       # one literal
    hl[2, 260], hd[2, 3] = 4, 4         # one length, one distance
    hd[3, 0] = 9                        # a distance and no length
    hl[4, 0] = 3                        # symbol 0 alone
    hl[5, 273] = 15                     # fixed and dynamic both cost 160 bits
    return hl, hd, np.array([0, 5, 16, 9, 3, 100]), np.array([0, 1, 0, 1, 1, 0]), 8


def _deep_rows(rng):
    hl, hd = _random_rows(rng, 4)
    hl[0] = 0
    hl[0, rng.choice(256, 24, replace=False)] = _fib(24)
    hd[0] = _fib(ND)[rng.permutation(ND)]
    hd[1] = _fib(ND)
    hl[2], hd[2] = _deep_precode_row(rng)
    hl[3] = 0
    hl[3, :26] = _fib(26)[::-1]
    for i in (0, 3):
        assert _redistributed(_planned(hl[i], hd[i])[0], 15)
    assert _redistributed(hd[1].astype(np.int64), 15)
    # long enough that the deep trees beat a stored block
    n_valid = np.array([50_000_000, 50_000_000, de.SEGMENT_SIZE, 50_000_000])
    return hl, hd, n_valid, np.array([0, 0, 1, 0]), 4


def _one_row(rng):
    hl, hd = _random_rows(rng, 1)
    return hl, hd, np.array([40_000]), np.array([1]), 2


def _full_batch(rng):
    hl, hd = _random_rows(rng, 8, skew=int(rng.integers(1000, 100_000)))
    hl[5] = 0
    hl[5, :256] = 200                   # flat literals
    hd[5] = 0
    # 130,510 8-bit and 50 9-bit fixed codes: 20 bits under two stored chunks
    hl[7] = 0
    hl[7, :144] = 906
    hl[7, :46] += 1
    hl[7, 200] = 50
    hd[7] = 0
    n_valid = np.array([de.SEGMENT_SIZE] * 4 + [77, 51_200, 4096, de.SEGMENT_SIZE])
    return hl, hd, n_valid, np.arange(8) == 7, 16


def _stored_wins(rng):
    hl, hd = _random_rows(rng, 8, skew=200)
    return hl, hd, rng.integers(0, 20, 8), np.array([1, 0, 1, 1, 0, 0, 1, 0]), 8


CASES = {"tiny": _tiny_rows, "deep": _deep_rows, "one_row": _one_row,
         "full_batch": _full_batch, "stored_wins": _stored_wins}


def _shared(shared, hl, hd):
    if shared != "tuple":
        return shared
    lit = huffman.code_lengths_from_frequencies(hl.astype(np.int64).sum(0) + 1)
    dist = huffman.code_lengths_from_frequencies(hd.astype(np.int64).sum(0) + 1)
    return lit, dist, de.build_dynamic_header(lit, dist)


@pytest.mark.parametrize("shared", [False, True, "tuple"])
@pytest.mark.parametrize("force", [None, "fixed", "dynamic"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_native_plan_equals_reference(case, force, shared):
    rng = np.random.default_rng(sorted(CASES).index(case))
    hl, hd, n_valid, finals, pad_to = CASES[case](rng)
    tree = _shared(shared, hl, hd)
    got = de.plan_blocks(hl, hd, n_valid, finals, pad_to=pad_to, force_block=force,
                         shared_tree=tree)
    want = ref_de.plan_blocks(hl, hd, n_valid, finals, pad_to=pad_to,
                              force_block=force, shared_tree=tree)
    assert got[2] == want[2]
    assert len(got[2]) == len(hl)
    for g, w in zip((*got[0], *got[1]), (*want[0], *want[1])):
        assert g.dtype == w.dtype and g.shape == w.shape and g.shape[0] == pad_to
        np.testing.assert_array_equal(g, w)


def test_whole_gzip_stream_equals_the_reference_planner(monkeypatch):
    """Ten 4 KiB segments (two batches): text, random bytes and a short
    tail, so that the planner chooses more than one kind."""
    rng = np.random.default_rng(20)
    words = [rng.integers(97, 123, rng.integers(2, 9), np.uint8).tobytes()
             for _ in range(200)]
    text = b" ".join(words[i] for i in rng.integers(0, len(words), 9000))
    x = text[:28_000] + rng.integers(0, 256, 8192, np.uint8).tobytes() + text[:700]
    assert 9 * 4096 < len(x) <= 10 * 4096
    before = collections.Counter(de.PLAN_COUNTS)
    native = gz.compress(x, 6, segment_size=4096, device="cpu")
    counts = de.PLAN_COUNTS - before
    assert sum(counts[k] > 0 for k in ("stored", "fixed", "dynamic")) >= 2, counts
    assert counts["stored"] + counts["fixed"] + counts["dynamic"] == 10
    monkeypatch.setattr(de, "plan_blocks", ref_de.plan_blocks)
    reference = gz.compress(x, 6, segment_size=4096, device="cpu")
    assert native == reference
    assert gzip.decompress(native) == x


@pytest.mark.parametrize("shared", [False, True, "tuple"])
def test_plan_counts_count_kinds_and_overflow(shared):
    rng = np.random.default_rng(5)
    hl, hd, n_valid, finals, pad_to = _deep_rows(rng)
    hl2, hd2, nv2, fin2, _ = _stored_wins(rng)
    hl, hd = np.concatenate([hl, hl2[:3]]), np.concatenate([hd, hd2[:3]])
    n_valid, finals = np.concatenate([n_valid, nv2[:3]]), np.concatenate([finals, fin2[:3]])
    tree = _shared(shared, hl, hd)
    want = ref_de.plan_blocks(hl, hd, n_valid, finals, force_block=None,
                              shared_tree=tree)[2]
    if shared is True:
        sums = _planned(hl.sum(0), hd.sum(0))[0], hd.astype(np.int64).sum(0)
        sums[0][de.EOB] += len(hl) - 1
        overflow = len(hl) * any(_redistributed(f, 15) for f in sums)
    elif shared:
        overflow = 0
    else:
        overflow = sum(any(_redistributed(f, 15) for f in _planned(a, d))
                       for a, d in zip(hl, hd))
    assert shared or overflow == 3
    before = collections.Counter(de.PLAN_COUNTS)
    de.plan_blocks(hl, hd, n_valid, finals, shared_tree=tree)
    got = {k: de.PLAN_COUNTS[k] - before[k] for k in ("stored", "fixed", "dynamic",
                                                      "overflow")}
    assert got == {"stored": want.count("stored"), "fixed": want.count("fixed"),
                   "dynamic": want.count("dynamic"), "overflow": overflow}


def test_shapes_outside_the_planners_are_refused():
    hl = np.zeros((2, NL - 1), np.int32)
    hd = np.zeros((2, ND), np.int32)
    with pytest.raises(ValueError, match="histograms"):
        de.plan_blocks(hl, hd, [1, 1], [0, 1])
