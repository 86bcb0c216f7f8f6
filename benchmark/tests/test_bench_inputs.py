"""Seeded inputs: one seed gives the same bytes, another seed another
order of the same bytes."""

import collections

import numpy as np
import pytest

from benchmark import inputs

SIZE = 1 << 20


@pytest.fixture(scope="module")
def files():
    return inputs.load_corpus("calgary")


def test_corpus_is_the_14_calgary_files(files):
    assert len(files) == 14
    assert sum(f.size for f in files) == 3_141_622


@pytest.mark.parametrize("seed", [0, 7, (1 << 31) + 12345, (1 << 40) + 3])
def test_seed_repeats_byte_for_byte(files, seed):
    a = inputs.make_input(files, SIZE, seed, 1)
    b = inputs.make_input(files, SIZE, seed, 1)
    assert a.size == SIZE
    assert np.array_equal(a, b)


def test_seeds_and_indexes_differ(files):
    base = inputs.make_input(files, SIZE, 11, 0)
    for other in [(12, 0), (11, 1), ((1 << 32) + 11, 0)]:
        assert not np.array_equal(base, inputs.make_input(files, SIZE, *other))


@pytest.mark.parametrize("size", [8 << 20, 16 << 20, 3_141_622, 100_000])
def test_every_seed_holds_the_same_bytes(files, size):
    counts = [np.bincount(inputs.make_input(files, size, s, 0), minlength=256)
              for s in (1, 2, (1 << 33) + 1)]
    assert all(np.array_equal(counts[0], c) for c in counts[1:])


@pytest.mark.parametrize("rem", [0, 1, 13, 2_105_364, 3_000_111])
def test_prefix_lengths_sum_to_the_remainder(rem):
    lengths = [5, 100, 7, 3_000_000]
    take = inputs.prefix_lengths(lengths, rem)
    assert sum(take) == rem
    assert all(0 <= t <= n for t, n in zip(take, lengths))
    assert collections.Counter(inputs.prefix_lengths([10, 10], 5)) == {2: 1, 3: 1}


def test_make_inputs_shape():
    data = inputs.make_inputs("calgary", 4096, 5, 3)
    assert len(data) == 3
    assert all(x.size == 4096 for x in data)
