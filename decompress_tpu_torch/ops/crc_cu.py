"""Per-chunk CRC-32 registers: the zero-init register of every 256-byte
chunk, as 32 register bits (bit j in column j).

A zero-init CRC register is linear over GF(2) in the message bits, so
one chunk's register is ``bits(chunk) @ H (mod 2)`` with H the
[2048, 32] matrix of ``checksum._crc_chunk_matrix``.  The plain version
computes exactly that (bits unpacked, a float32 matmul, parity).

Replaces ``decompress_tpu/ops/checksum.py: _crc_matmul_pallas`` (a GF(2)
matmul on the TPU's matrix unit) with ``csrc/crc.cu``: the same function
as the classic table-driven CRC, one thread per chunk over its 256 bytes
with the 256-entry byte table in shared memory.
"""

from __future__ import annotations

import torch

from .. import _build
from . import checksum


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


def chunk_registers(chunks: torch.Tensor) -> torch.Tensor:
    """Register bits int32[M, 32] of uint8[M, CRC_CHUNK] chunks.  A CPU
    tensor takes :func:`chunk_registers_plain`; a CUDA tensor launches
    the kernel (or raises)."""
    if chunks.device.type == "cpu":
        return chunk_registers_plain(chunks)
    m = chunks.shape[0]
    _build.check_cuda("chunks", chunks, torch.uint8, (m, checksum.CRC_CHUNK))
    if chunks.data_ptr() % 16:
        raise ValueError("chunks: expected a 16-byte aligned tensor")
    out = torch.empty((m, 32), dtype=torch.int32, device=chunks.device)
    table = torch.from_numpy(checksum._crc_byte_table().view("i4")).to(chunks.device)
    err = _build.lib().dtt_crc_chunks(chunks.data_ptr(), table.data_ptr(),
                                      out.data_ptr(), m, _build.stream(chunks))
    _build.launched("chunk_registers", err)
    return out
