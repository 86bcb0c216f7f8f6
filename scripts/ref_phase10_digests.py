#!/usr/bin/env python3
"""The reference digests ``chip_smoke.py`` phase 10 checks, derived with
the JAX package (``decompress_tpu``) on the CPU, about a minute:

    JAX_PLATFORMS=cpu python scripts/ref_phase10_digests.py

Prints, for the 8 MiB corpus of ``chip_smoke.py`` (the ``tests/corpus``
files, sorted, concatenated, repeated, cut to 8,388,608 bytes): the size
and sha256 of ``lzo.compress`` at level 6; of
``pipeline.fixed_deflate_segments`` of its first 8 x 2^17 bytes (B = 8,
seg_len = 2^17, no history, bfinal 1) the totals and the sha256 of the
words as little-endian uint32; and the size and sha256 of the level-6
``sharded_gzip_compress`` with ``shared_tree=True``.
"""

import hashlib
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax.numpy as jnp  # noqa: E402

from decompress_tpu import lzo  # noqa: E402
from decompress_tpu.ops import lz77, pipeline  # noqa: E402
from decompress_tpu.parallel import sharded  # noqa: E402

SIZE = 8 << 20
FIXED_B, FIXED_SEG = 8, 1 << 17


def corpus_bytes() -> bytes:
    base = b"".join(p.read_bytes() for p in sorted((ROOT / "tests" / "corpus").iterdir()))
    return (base * -(-SIZE // len(base)))[:SIZE]


def digest(label: str, out: bytes) -> None:
    print(f"{label}: {len(out)} {hashlib.sha256(out).hexdigest()}", flush=True)


def main() -> None:
    data = corpus_bytes()
    digest("lzo.compress level 6", lzo.compress(data, level=6))
    rows = np.zeros((FIXED_B, lz77.HIST + FIXED_SEG), np.uint8)
    rows[:, lz77.HIST:] = np.frombuffer(data[:FIXED_B * FIXED_SEG], np.uint8).reshape(
        FIXED_B, FIXED_SEG)
    n = np.full(FIXED_B, FIXED_SEG, np.int32)
    words, totals = pipeline.fixed_deflate_segments(
        jnp.asarray(rows), jnp.asarray(n), jnp.zeros(FIXED_B, jnp.int32),
        jnp.ones(FIXED_B, jnp.int32), level=6, seg_len=FIXED_SEG)
    print(f"fixed_deflate_segments totals: {np.asarray(totals).tolist()}")
    digest("fixed_deflate_segments words", np.asarray(words).astype("<u4").tobytes())
    digest("sharded_gzip_compress level 6 shared_tree",
           sharded.sharded_gzip_compress(data, 6, shared_tree=True))


if __name__ == "__main__":
    main()
