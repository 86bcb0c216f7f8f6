"""The port's CRC-32 (``ops/checksum.py``, ``ops/crc_cu.py``) against the
reference's ``ops/checksum.py`` and ``zlib.crc32``, on the CPU.

The chunk registers' plain version is held equal to the reference's
Pallas kernel ``_crc_matmul_pallas`` in interpret mode, the host GF(2)
helpers to the reference's, and the batched and one-row CRCs to the
reference's and to zlib at lengths around the 256-byte chunk and at a
full member (130,560 bytes).  ``crc32_rows`` (its plain version, on a
CPU tensor) equals the reference's ``crc32_batch_device`` and zlib at
lengths 0 to 2^20 + 3, with init values; a numpy model of the CUDA
kernel's fold plan, which cannot run here, equals zlib at the same
lengths for every block size, misaligned rows and junk past each
length.  Adler-32 (torch on the CPU tensor) and the host combines of
both checksums equal the reference's and zlib's at lengths around the
512-byte chunk and zlib's 5,552-byte NMAX, with start values, on all-0xff
input (the sums' largest values) and on a uint8 tensor.  Exact equality
throughout (integers).
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
    assert (checksum.ADLER_CHUNK, checksum.ADLER_MOD) == (ref.ADLER_CHUNK, ref.ADLER_MOD)
    np.testing.assert_array_equal(checksum._crc_byte_table(), ref._crc_byte_table())
    for k in (0, 1, 7, 17):
        np.testing.assert_array_equal(checksum._crc_shift_pow2(k), ref._crc_shift_pow2(k))
    np.testing.assert_array_equal(checksum._crc_chunk_matrix(), ref._crc_chunk_matrix())
    for level in (0, 3, 9):
        np.testing.assert_array_equal(checksum._crc_level_matrix(level),
                                      ref._crc_level_matrix(level))
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
    got = crc_cu.chunk_registers_plain(torch.from_numpy(chunks))
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


ROW_LENGTHS = (0, 1, 15, 16, 17, 255, 256, 257, 4095, 130_560, (1 << 20) + 3)


@pytest.mark.parametrize("n", ROW_LENGTHS)
def test_crc32_rows_matches_reference_and_zlib(n):
    """The plain version (a CPU tensor) against the reference's
    ``crc32_batch_device`` and ``zlib.crc32``, with and without init."""
    rng = np.random.default_rng(n + 5)
    data = np.zeros((1, n + 5), np.uint8)
    data[0, :n] = rng.integers(0, 256, n, dtype=np.uint8)
    lengths = torch.tensor([n], dtype=torch.int32)
    got = crc_cu.crc32_rows(torch.from_numpy(data), lengths)
    assert got.dtype == torch.int64
    assert got.tolist() == ref.crc32_batch_device(jnp.asarray(data), np.array([n])).tolist()
    assert got.tolist() == [zlib.crc32(data[0, :n].tobytes())]
    value = int(rng.integers(0, 1 << 32))
    init = torch.tensor([value], dtype=torch.int64)
    assert crc_cu.crc32_rows(torch.from_numpy(data), lengths, init).tolist() == [
        zlib.crc32(data[0, :n].tobytes(), value)]


def _kernel_model(row: np.ndarray, n: int, value: int, spans: int, offset: int) -> int:
    """``csrc/crc.cu``'s fold plan for one row, in numpy: the row's bytes
    at virtual offset ``offset`` (its address mod 16) with zeros before
    it; 16-byte pieces of blocks of 8 warps x 32 lanes x ``spans``
    sub-spans of 4,096 bytes, each piece folded from zero through the
    byte table; a lane's pieces joined by "advance 4,096 bytes", a warp's
    lanes by the shuffle-down tree with "advance 16 * 2^j bytes" and a
    block's warps by the same tree with "advance 512 * 2^j bytes" (the
    hex-digit tables of ``fold_ops``); each block's register advanced to
    the row's end by the hex-digit matrices of ``nibble_matrices`` (a
    negative distance taken mod 2^32 - 1) and XORed; block 0 adds the
    init term.  Only ``row[:n]`` is read."""
    table = checksum._crc_byte_table().astype(np.uint64)
    ops = crc_cu.fold_ops().astype(np.uint64)
    nibble = crc_cu.nibble_matrices().astype(np.uint64)
    span = spans * crc_cu.SUB_BYTES
    blocks = -(-(row.size + 15) // span)
    nv = offset + n
    virtual = np.zeros(blocks * span, np.uint8)
    virtual[offset:nv] = row[:n]
    pieces = virtual.reshape(blocks, spans, 8, 32, 16).astype(np.uint64)

    def advance_op(k, r):
        return np.bitwise_xor.reduce([ops[k, q][(r >> np.uint64(4 * q)) & 15]
                                      for q in range(8)])

    def shuffle_tree(r, levels, first_op):  # over the last axis, as __shfl_down_sync
        lanes = np.arange(r.shape[-1])
        for j in range(levels):
            src = np.where(lanes + (1 << j) < lanes.size, lanes + (1 << j), lanes)
            r = advance_op(first_op + j, r) ^ r[..., src]
        return r[..., 0]

    def advance_by(r, dist):
        for p in range(8):
            d = (dist >> np.uint64(4 * p)) & np.uint64(15)
            bits = (r[:, None] >> np.arange(32, dtype=np.uint64)) & 1
            moved = np.bitwise_xor.reduce(np.where(bits == 1, nibble[p, d.astype(int)], 0), 1)
            r = np.where(d > 0, moved, r)
        return r

    regs = np.zeros(pieces.shape[:4], np.uint64)
    for i in range(16):
        regs = (regs >> np.uint64(8)) ^ table[(regs ^ pieces[..., i]) & 0xFF]
    r = regs[:, 0]
    for k in range(1, spans):
        r = advance_op(8, r) ^ regs[:, k]
    block = shuffle_tree(shuffle_tree(r, 5, 0), 3, 5)
    start0 = np.arange(blocks) * span
    shift = nv - (start0[start0 < nv] + span)
    contrib = advance_by(block[start0 < nv],
                         np.where(shift >= 0, shift, shift + 0xFFFFFFFF).astype(np.uint64))
    start = np.array([value ^ 0xFFFFFFFF], np.uint64)
    out = int(advance_by(start, np.array([n], np.uint64))[0]) ^ 0xFFFFFFFF
    return out ^ int(np.bitwise_xor.reduce(contrib)) if contrib.size else out


@pytest.mark.parametrize("offset", [0, 7])
@pytest.mark.parametrize("spans", [1, 2, 4, 8])
def test_kernel_fold_plan_model_matches_zlib(spans, offset):
    """The CPU model of the kernel's algebra equals ``zlib.crc32`` at every
    length, with init values, rows misaligned by ``offset`` and nonzero
    junk past each length (which the plan never reads)."""
    rng = np.random.default_rng(spans * 16 + offset)
    for n in ROW_LENGTHS:
        row = rng.integers(0, 256, n + 40, dtype=np.uint8)
        value = int(rng.integers(0, 1 << 32))
        want = zlib.crc32(row[:n].tobytes(), value)
        assert _kernel_model(row, n, value, spans, offset) == want, n


ADLER_LENGTHS = (0, 1, 511, 512, 513, 5552, 5553, 70_001)


@pytest.mark.parametrize("n", ADLER_LENGTHS)
def test_adler32_matches_reference_and_zlib(n):
    rng = np.random.default_rng(n + 3)
    x = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    start = int(rng.integers(0, 1 << 32))
    for data in (x, b"\xff" * n):
        want = zlib.adler32(data)
        assert checksum.adler32(data, device="cpu") == want == ref.adler32(data)
        assert checksum.adler32(data, start, device="cpu") == zlib.adler32(data, start) \
            == ref.adler32(data, start)
    t = torch.from_numpy(np.frombuffer(x, np.uint8).copy())
    assert checksum.adler32(t) == zlib.adler32(x)
    parts = checksum._adler_partials(t[: n - n % 512].reshape(-1, 512))
    want_parts = ref._adler_partials(jnp.asarray(np.frombuffer(x[: n - n % 512], np.uint8)
                                                 .reshape(-1, 512).astype(np.int32)))
    for g, w in zip(parts, want_parts):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("split", [0, 1, 511, 5553, 9000])
def test_combines_match_reference_and_zlib(split):
    x = np.random.default_rng(split).integers(0, 256, 9000, dtype=np.uint8).tobytes()
    a, b = x[:split], x[split:]
    got = checksum.adler32_combine(zlib.adler32(a), zlib.adler32(b), len(b))
    assert got == zlib.adler32(x) == ref.adler32_combine(zlib.adler32(a), zlib.adler32(b),
                                                         len(b))
    got = checksum.crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b))
    assert got == zlib.crc32(x) == ref.crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b))


def test_crc32_batch_matches_reference():
    """Host rows with junk past each length, as the reference's
    crc32_batch takes them."""
    rng = np.random.default_rng(3)
    rows = rng.integers(1, 256, (7, 700), dtype=np.uint8)
    lengths = np.array([0, 1, 255, 256, 257, 699, 700], np.int32)
    got = checksum.crc32_batch(rows, lengths, device="cpu")
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, ref.crc32_batch(rows, lengths))
    assert got.tolist() == [zlib.crc32(rows[i, :n].tobytes()) for i, n in enumerate(lengths)]
