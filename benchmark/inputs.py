"""Seeded inputs: a corpus's files concatenated in drawn orders, repeated
and cut to size, in NumPy.

An input of ``size`` bytes holds ``size // C`` whole copies of the corpus
(C bytes), each copy's files in an order of its own, then the remaining
``size % C`` bytes as a prefix of every file in proportion to its length,
in one more drawn order.  So every input of one size holds the same bytes
of every file whatever the seed; the seed draws only the order.  The
orders come from ``numpy.random.default_rng((seed, index))``.
"""

from __future__ import annotations

import pathlib

import numpy as np

CORPUS_DIR = pathlib.Path(__file__).resolve().parent / "corpus"


def load_corpus(name: str) -> list[np.ndarray]:
    """The files of corpus ``name`` (``corpus/<name>/``), sorted by name."""
    files = sorted((CORPUS_DIR / name).iterdir())
    if not files:
        raise FileNotFoundError(f"corpus {name!r} has no files")
    return [np.frombuffer(p.read_bytes(), np.uint8) for p in files]


def prefix_lengths(lengths: list[int], remainder: int) -> list[int]:
    """Bytes taken from the front of each file so that they sum to
    ``remainder``: each file's share of it by length, rounded down, and
    the shortfall from the longest files, one byte each."""
    total = sum(lengths)
    take = [n * remainder // total for n in lengths]
    short = remainder - sum(take)
    for i in sorted(range(len(lengths)), key=lambda i: -lengths[i])[:short]:
        take[i] += 1
    return take


def make_input(files: list[np.ndarray], size: int, seed: int, index: int) -> np.ndarray:
    """Input ``index`` of ``size`` bytes (see the module docstring)."""
    rng = np.random.default_rng((seed % (1 << 64), index))
    lengths = [f.size for f in files]
    whole, remainder = divmod(size, sum(lengths))
    pieces = []
    for _ in range(whole):
        pieces.extend(files[i] for i in rng.permutation(len(files)))
    take = prefix_lengths(lengths, remainder)
    pieces.extend(files[i][: take[i]] for i in rng.permutation(len(files)))
    out = np.concatenate(pieces)
    if out.size != size:
        raise ValueError(f"made {out.size} bytes, not {size}")
    return out


def make_inputs(corpus: str, size: int, seed: int, count: int) -> list[np.ndarray]:
    """``count`` inputs of ``size`` bytes."""
    files = load_corpus(corpus)
    return [make_input(files, size, seed, j) for j in range(count)]
