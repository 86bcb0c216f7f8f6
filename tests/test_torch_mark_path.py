"""Port's mark path == the reference's, bit for bit.

The plain version (``parse_cu.mark_path_plain``, which the wrapper takes
for CPU tensors) is held against the Pallas kernel in interpret mode
(``parse_pl.mark_path_pl``) and against ``lz77._mark_path``, on the
jump arrays the parse produces, on the extremes (all literals, all
258-byte jumps) and on jumps of up to 2,000 positions.  The CUDA kernel
is held against the same plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from decompress_tpu.ops import lz77, parse_pl
from decompress_tpu_torch.ops import parse_cu
from decompress_tpu_torch.ops import lz77 as port_lz77


def _random_jumps(rng, b, p, seg_len):
    """g[i] = i + step, step 1 or [3, 258], clipped to p; tail steps 1."""
    step = np.ones((b, p), np.int64)
    take = rng.random((b, seg_len)) < 0.3
    ln = rng.integers(3, 259, size=(b, seg_len))
    step[:, :seg_len] = np.where(take, ln, 1)
    return np.minimum(np.arange(p)[None, :] + step, p).astype(np.int32)


def _check(g):
    p = g.shape[1]
    levels = p.bit_length() - 1
    got = parse_cu.mark_path(torch.from_numpy(g)).numpy()
    want_pl = np.asarray(parse_pl.mark_path_pl(jnp.asarray(g), interpret=True))
    want = np.asarray(jax.vmap(lambda x: lz77._mark_path(x, levels))(jnp.asarray(g)))
    np.testing.assert_array_equal(got, want_pl)
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("p,seg_len,b", [(4096, 4096, 3), (8192, 7777, 2),
                                         (1024, 1000, 1)])
def test_mark_path_matches_reference(p, seg_len, b):
    _check(_random_jumps(np.random.default_rng(p + b), b, p, seg_len))


@pytest.mark.parametrize("step", [1, 258])
def test_mark_path_extremes(step):
    p = 2048
    g = np.minimum(np.arange(p) + step, p).astype(np.int32)[None, :]
    got = _check(g)[0]
    want = np.zeros(p, bool)
    want[::step] = True
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p,max_step,take_p", [(4096, 2000, 0.2), (8192, 2000, 0.05),
                                               (2048, 1000, 1.0)])
def test_mark_path_generic_jumps(p, max_step, take_p):
    """Jumps longer than a match (up to 2,000): a walk may enter a
    1024-position chunk far past the kernel's 288-exit head table, and
    cross chunks without landing in them."""
    rng = np.random.default_rng(p + max_step)
    step = np.where(rng.random((2, p)) < take_p,
                    rng.integers(1, max_step + 1, (2, p)), 1)
    g = np.minimum(np.arange(p)[None, :] + step, p).astype(np.int32)
    got = _check(g)
    assert got[:, 0].all() and got.sum() < 2 * p // 4


def test_jump_array_matches_reference_parse():
    """The port's jump build + mark path on real take/length arrays
    equals the reference's ``_mark_batched`` (XLA hybrid walk)."""
    rng = np.random.default_rng(3)
    seg_len, p = 3000, 4096
    plen = rng.integers(0, 259, (2, seg_len)).astype(np.int32)
    take = (plen >= 3) & (rng.random((2, seg_len)) < 0.5)
    want = np.asarray(lz77._mark_batched(jnp.asarray(take), jnp.asarray(plen),
                                         seg_len, p, p.bit_length() - 1))
    got = port_lz77._mark_batched(torch.from_numpy(take), torch.from_numpy(plen),
                                  seg_len, p).numpy()
    np.testing.assert_array_equal(got, want)
