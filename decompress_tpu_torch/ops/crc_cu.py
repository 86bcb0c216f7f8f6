"""CRC-32 of each row of a byte matrix on the card, in one kernel.

:func:`crc32_rows` gives ``zlib.crc32(row_i[:lengths[i]], init[i])`` for
every row of a uint8[M, L] tensor, as int64[M] on the tensor's device.
A CUDA tensor launches ``csrc/crc.cu`` (one kernel after a memset of the
output): 16-byte pieces folded through a byte table, joined by fixed
"advance 16 * 2^j bytes" operators (:func:`fold_ops`), each block's
register advanced to its row's end by per-hex-digit GF(2) matrices
(:func:`nibble_matrices`) and XORed into the row's word, the init term
folded in by the first block.  It reads each row's first
``lengths[i]`` bytes and nothing past them.

:func:`crc32_rows_plain` composes the same function from the
reference's steps in torch: the back-aligned power-of-two rows
(``checksum.back_aligned``), the chunk registers of
:func:`chunk_registers_plain` (``bits @ H`` and parity, as the TPU kernel
computes them), the combine tree (``checksum._combine_tree``) and the
init and final XOR as GF(2) matrix steps.  Like the reference, it needs
zero bytes past each length.

Replaces ``decompress_tpu/ops/checksum.py: _crc_matmul_pallas`` (a GF(2)
matmul on the TPU's matrix unit) and the combine tree and host finish
around it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from . import checksum

#: sub-span of a kernel block: 256 threads x 16-byte pieces
SUB_BYTES = 4096
#: fixed advances of the kernel's fold, in bytes, as rows of fold_ops():
#: lanes of a warp (j < 5), warps of a block (j = 5..7), sub-spans (j = 8)
FOLD_ADVANCES = tuple(16 << j for j in range(9))
#: widest row the kernel takes: int32 lengths, and a row's end plus its
#: up to 15 bytes of alignment below 2^31
MAX_WIDTH = (1 << 31) - 16
#: blocks wanted before a block takes more sub-spans: two an H100 SM
#: (on the decode's 65 rows 8 sub-spans a block beat 4, 2 and 1)
MIN_BLOCKS = 264


def _shift_cols(n: int) -> np.ndarray:
    """uint32[32]: the image of register bit j through n zero bytes."""
    return np.array([checksum.crc_advance(1 << j, n) for j in range(32)], np.uint32)


@functools.cache
def fold_ops() -> np.ndarray:
    """uint32[9, 8, 16]: for each of FOLD_ADVANCES, the eight hex-digit
    tables of "advance n zero bytes": adv(r) = XOR over q of
    t[q][hex digit q of r]."""
    bits = (np.arange(16)[:, None] >> np.arange(4)) & 1  # [digit value, bit]
    ops = np.zeros((len(FOLD_ADVANCES), 8, 16), np.uint32)
    for k, n in enumerate(FOLD_ADVANCES):
        cols = _shift_cols(n)
        for q in range(8):
            sel = np.where(bits == 1, cols[4 * q: 4 * q + 4][None, :], 0)
            ops[k, q] = np.bitwise_xor.reduce(sel, axis=1)
    return ops


@functools.cache
def nibble_matrices() -> np.ndarray:
    """uint32[8, 16, 32]: [p, d] is "advance d * 16^p zero bytes" as the
    image of each register bit ([p, 0] is the identity)."""
    out = np.zeros((8, 16, 32), np.uint32)
    for p in range(8):
        step = checksum._crc_shift_pow2(4 * p)
        out[p, 0] = 1 << np.arange(32, dtype=np.uint64)
        for d in range(1, 16):
            out[p, d] = checksum._gf2_matmul(step, out[p, d - 1])
    return out


@functools.cache
def _device_tables(device: torch.device) -> tuple:
    return tuple(torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)
                 for a in (checksum._crc_byte_table(), fold_ops(), nibble_matrices()))


def _spans(m: int, width: int) -> int:
    """Sub-spans a block takes: the most of 8, 4 and 2 that still gives
    MIN_BLOCKS blocks, else 1."""
    for k in (8, 4, 2):
        if m * -(-(width + 15) // (k * SUB_BYTES)) >= MIN_BLOCKS:
            return k
    return 1


def chunk_registers_plain(chunks: torch.Tensor) -> torch.Tensor:
    """int32[M, 32] register bits of uint8[M, CRC_CHUNK] chunks, as the
    reference computes them: ``bits @ H`` in float32, then parity (the
    counts are exact small integers)."""
    shifts = torch.arange(8, device=chunks.device, dtype=torch.int32)
    bits = (chunks.to(torch.int32)[:, :, None] >> shifts) & 1
    bits = bits.reshape(chunks.shape[0], 8 * checksum.CRC_CHUNK)
    h = torch.from_numpy(checksum._crc_chunk_matrix()).to(chunks.device)
    acc = bits.to(torch.float32) @ h.to(torch.float32)
    return acc.to(torch.int32) & 1


def _advance_plain(regs: torch.Tensor, nbytes: torch.Tensor) -> torch.Tensor:
    """int64 registers advanced by ``nbytes[i]`` zero bytes: one 32x32
    GF(2) matrix per length bit (a float32 product of exact counts)."""
    weights = torch.ones(32, dtype=torch.int64, device=regs.device) << torch.arange(
        32, device=regs.device)
    for k in range(int(nbytes.max()).bit_length() if nbytes.numel() else 0):
        cols = torch.from_numpy(checksum._crc_shift_pow2(k).astype(np.int64)).to(regs.device)
        mat = ((cols[:, None] >> torch.arange(32, device=regs.device)) & 1).to(torch.float32)
        bits = ((regs[:, None] >> torch.arange(32, device=regs.device)) & 1).to(torch.float32)
        moved = (((bits @ mat).to(torch.int64) & 1) * weights).sum(1)
        regs = torch.where((nbytes >> k) & 1 == 1, moved, regs)
    return regs


def crc32_rows_plain(data_2d: torch.Tensor, lengths: torch.Tensor,
                     init: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`crc32_rows` in torch from the reference's steps; bytes at
    and past ``lengths[i]`` MUST be zero (see ``checksum.back_aligned``)."""
    m, width = data_2d.shape
    dev = data_2d.device
    lengths = lengths.to(dev, torch.int64).clamp(0, width)
    if width == 0:
        data_2d = data_2d.new_zeros((m, 1))
    rows = checksum.back_aligned(data_2d, lengths)
    bits = checksum._combine_tree(
        chunk_registers_plain(rows.reshape(-1, checksum.CRC_CHUNK)).reshape(m, -1, 32))
    weights = torch.ones(32, dtype=torch.int64, device=dev) << torch.arange(32, device=dev)
    regs = (bits.to(torch.int64) * weights).sum(1)
    start = torch.zeros(m, dtype=torch.int64, device=dev) if init is None else init.to(dev)
    return _advance_plain((start & 0xFFFFFFFF) ^ 0xFFFFFFFF, lengths) ^ regs ^ 0xFFFFFFFF


def crc32_rows(data_2d: torch.Tensor, lengths: torch.Tensor,
               init: torch.Tensor | None = None) -> torch.Tensor:
    """int64[M] holding ``zlib.crc32(row_i[:lengths[i]], init[i])`` (0
    for init) of uint8[M, L] rows (each row contiguous, any row stride),
    on their device; lengths int32[M] (clamped to [0, L]), init int64[M].
    A CPU tensor takes :func:`crc32_rows_plain`; a CUDA tensor launches
    the kernel (or raises)."""
    if data_2d.device.type == "cpu":
        return crc32_rows_plain(data_2d, lengths, init)
    m, width = data_2d.shape
    _build.check_rows("data_2d", data_2d, torch.uint8, (m, width))
    _build.check_cuda("lengths", lengths, torch.int32, (m,))
    if init is not None:
        _build.check_cuda("init", init, torch.int64, (m,))
    if width > MAX_WIDTH:
        raise ValueError(f"data_2d: rows of {width} bytes, above {MAX_WIDTH}")
    byte_table, ops, nibble = _device_tables(data_2d.device)
    out = torch.empty(m, dtype=torch.int64, device=data_2d.device)
    err = _build.lib().dtt_crc_rows(
        data_2d.data_ptr(), data_2d.stride(0), m, width, lengths.data_ptr(),
        None if init is None else init.data_ptr(), byte_table.data_ptr(), ops.data_ptr(),
        nibble.data_ptr(), out.data_ptr(), _spans(m, width), _build.stream(data_2d))
    _build.launched("crc32_rows", err)
    return out
