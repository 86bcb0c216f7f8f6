"""The port's CRC-32 (``ops/checksum.py``, ``ops/crc_cu.py``) against the
reference's ``ops/checksum.py`` and ``zlib.crc32``, on the CPU.

The chunk registers' plain version is held equal to the reference's
Pallas kernel ``_crc_matmul_pallas`` in interpret mode, the host GF(2)
helpers to the reference's, and the batched and one-row CRCs to the
reference's and to zlib at lengths around the 256-byte chunk and at a
full member (130,560 bytes).  Exact equality throughout (integers).
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decompress_tpu.ops import checksum as ref
from decompress_tpu_torch.ops import checksum, crc_cu

LENGTHS = (0, 1, 255, 256, 257, 130_560)


def test_constants_and_host_helpers_match_reference():
    assert (checksum.CRC_CHUNK, checksum.CRC_POLY) == (ref.CRC_CHUNK, ref.CRC_POLY)
    np.testing.assert_array_equal(checksum._crc_byte_table(), ref._crc_byte_table())
    for k in (0, 1, 7, 17):
        np.testing.assert_array_equal(checksum._crc_shift_pow2(k), ref._crc_shift_pow2(k))
    np.testing.assert_array_equal(checksum._crc_chunk_matrix(), ref._crc_chunk_matrix())
    for level in (0, 3, 9):
        np.testing.assert_array_equal(checksum._crc_level_matrix(level),
                                      ref._crc_level_matrix(level))
    rng = np.random.default_rng(2)
    regs = rng.integers(0, 1 << 32, 50, dtype=np.uint64)
    nbytes = rng.integers(0, 1 << 20, 50)
    np.testing.assert_array_equal(checksum.crc_advance_batch(regs, nbytes),
                                  ref.crc_advance_batch(regs, nbytes))
    assert checksum.crc_advance(0x1234567, 99_999) == ref.crc_advance(0x1234567, 99_999)


def test_chunk_registers_plain_matches_pallas_interpret():
    rng = np.random.default_rng(0)
    chunks = rng.integers(0, 256, (130, checksum.CRC_CHUNK), dtype=np.uint8)
    chunks[3] = 0
    chunks[4] = 0xFF
    bits = ((chunks.astype(np.int32)[:, :, None] >> np.arange(8)) & 1).reshape(130, -1)
    want = np.asarray(ref._crc_matmul_pallas(
        jnp.asarray(bits, jnp.float32), jnp.asarray(ref._crc_chunk_matrix(), jnp.float32),
        interpret=True))
    got = crc_cu.chunk_registers(torch.from_numpy(chunks))  # CPU: the plain version
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[3].any()


def _batch(rng):
    width = max(LENGTHS)
    data = np.zeros((len(LENGTHS), width), np.uint8)
    for i, n in enumerate(LENGTHS):
        data[i, :n] = rng.integers(0, 256, n, dtype=np.uint8)
    return data, np.array(LENGTHS)


def test_crc32_batch_device_matches_reference_and_zlib():
    data, lengths = _batch(np.random.default_rng(1))
    got = checksum.crc32_batch_device(torch.from_numpy(data), lengths)
    want = ref.crc32_batch_device(jnp.asarray(data), lengths)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint32
    assert got.tolist() == [zlib.crc32(data[i, :n].tobytes()) for i, n in enumerate(lengths)]


@pytest.mark.parametrize("n", LENGTHS)
def test_crc32_matches_zlib(n):
    x = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert checksum.crc32(x, device="cpu") == zlib.crc32(x)
    assert checksum.crc32(x, 0xDEADBEEF, device="cpu") == zlib.crc32(x, 0xDEADBEEF)
