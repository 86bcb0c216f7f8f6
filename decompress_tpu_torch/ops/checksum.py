"""CRC-32 and Adler-32 on the card.

Counterpart of ``decompress_tpu/ops/checksum.py``.  :func:`crc32_batch_device`,
:func:`crc32_batch` (host rows)
and :func:`crc32` are ``crc_cu.crc32_rows`` (one CUDA kernel computes
each row's whole CRC-32, init and final XOR included) and one copy to
the host.

The CRC register is linear over GF(2) in the message bits.  The
reference's layout, which ``crc_cu.crc32_rows_plain`` keeps: rows
back-aligned (:func:`back_aligned`; leading zero bytes are no-ops for a
zero register, so any length maps onto a power-of-two number of
chunks), every 256-byte chunk's zero-init register computed
independently, and chunk pairs folded by "advance by k zero bytes"
matrices, level by level (:func:`_combine_tree`).

:func:`adler32` is torch code on the tensor's device, as the reference's
is jnp with no Pallas kernel: each ``ADLER_CHUNK``-byte chunk's sums S
and W (int32, summed straight from the bytes), then their weighted sum
mod 65521 in int64, so the reference's int32 tree of partial moduli
(``_mod_tree_sum``) is not needed.  The host combines (:func:`crc32_combine`,
:func:`adler32_combine`) are the reference's.

The host GF(2) helpers are copies of the reference's (numpy);
``tests/test_torch_checksum.py`` holds them and every result equal to
the reference's and to ``zlib``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import crc_cu, transfer

ADLER_MOD = 65521
ADLER_CHUNK = 512      # bytes per Adler-32 chunk
CRC_POLY = 0xEDB88320  # reflected CRC-32 (IEEE), as used by gzip/zlib
CRC_CHUNK = 256        # bytes per chunk register

# ---------------------------------------------------------------------------
# Host GF(2) helpers (numpy; copies of the reference's).
# ---------------------------------------------------------------------------


@functools.cache
def _crc_byte_table() -> np.ndarray:
    """Classic 256-entry CRC table: T[b] = register after byte b from 0."""
    t = np.zeros(256, dtype=np.uint64)
    for b in range(256):
        c = b
        for _ in range(8):
            c = (c >> 1) ^ (CRC_POLY if (c & 1) else 0)
        t[b] = c
    return t.astype(np.uint32)


def _gf2_matvec(mat: np.ndarray, v: int) -> int:
    """mat: uint32[32], mat[j] = image of basis bit j. Returns mat·v."""
    r = 0
    j = 0
    while v:
        if v & 1:
            r ^= int(mat[j])
        v >>= 1
        j += 1
    return r


def _gf2_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(a·b)[j] = a · (b[j])."""
    return np.array([_gf2_matvec(a, int(col)) for col in b], dtype=np.uint32)


@functools.cache
def _crc_shift_one_byte() -> np.ndarray:
    """M1: register advance by one zero byte, v -> (v>>8) ^ T[v & 0xFF]."""
    t = _crc_byte_table()
    cols = []
    for j in range(32):
        v = 1 << j
        cols.append(((v >> 8) ^ int(t[v & 0xFF])) & 0xFFFFFFFF)
    return np.array(cols, dtype=np.uint32)


@functools.cache
def _crc_shift_pow2(k: int) -> np.ndarray:
    """M1^(2^k): register advance by 2^k zero bytes."""
    if k == 0:
        return _crc_shift_one_byte()
    m = _crc_shift_pow2(k - 1)
    return _gf2_matmul(m, m)


def crc_advance(crc_reg: int, nbytes: int) -> int:
    """Advance a raw CRC register by ``nbytes`` zero bytes (host scalar)."""
    k = 0
    while nbytes:
        if nbytes & 1:
            crc_reg = _gf2_matvec(_crc_shift_pow2(k), crc_reg)
        nbytes >>= 1
        k += 1
    return crc_reg


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC of the concatenation from the CRCs of the halves: since init
    and final XOR are both 0xFFFFFFFF, ``M^len2 · crc1 ⊕ crc2``."""
    return crc_advance(crc1, len2) ^ crc2


def adler32_combine(a1: int, a2: int, len2: int) -> int:
    """Adler-32 of a concatenation from the halves' checksums."""
    s1_1, s2_1 = a1 & 0xFFFF, (a1 >> 16) & 0xFFFF
    s1_2, s2_2 = a2 & 0xFFFF, (a2 >> 16) & 0xFFFF
    s1 = (s1_1 + s1_2 - 1) % ADLER_MOD
    s2 = (s2_1 + s2_2 + (s1_1 - 1) * (len2 % ADLER_MOD)) % ADLER_MOD
    return (s2 << 16) | s1


@functools.cache
def _crc_chunk_matrix(chunk: int = CRC_CHUNK) -> np.ndarray:
    """H: int8[8*chunk, 32]; register contribution of a zero-init chunk is
    bits(chunk_bytes) @ H (mod 2), bit j of byte i at row 8*i+j."""
    t = _crc_byte_table()
    h = np.zeros((8 * chunk, 32), dtype=np.int8)
    # contribution of byte i, bit j: advance T[1<<j] by (chunk-1-i) zero bytes
    for i in range(chunk):
        for j in range(8):
            reg = crc_advance(int(t[1 << j]), chunk - 1 - i)
            h[8 * i + j] = (reg >> np.arange(32)) & 1
    return h


@functools.cache
def _crc_level_matrix(level: int, chunk: int = CRC_CHUNK) -> np.ndarray:
    """Bit matrix (int8[32,32]) advancing a register by chunk·2^level zero
    bytes: row j = bits of M^(chunk·2^level) e_j."""
    n = chunk << level
    cols = np.array([crc_advance(1 << j, n) for j in range(32)], dtype=np.uint64)
    return ((cols[:, None] >> np.arange(32, dtype=np.uint64)[None, :]) & 1).astype(np.int8)


def _padded_len(n: int) -> int:
    """Bytes of the back-aligned buffer for n bytes: a power-of-two
    number of chunks."""
    return CRC_CHUNK << max((n + CRC_CHUNK - 1) // CRC_CHUNK - 1, 0).bit_length()


# ---------------------------------------------------------------------------
# Device CRC.
# ---------------------------------------------------------------------------


def _combine_tree(partial: torch.Tensor) -> torch.Tensor:
    """Fold chunk registers int32[M, n, 32] (n a power of two) pairwise:
    the left half is advanced by the right half's byte count (one 32x32
    GF(2) matrix per level, a float32 product of exact small counts)
    and XORed into it.  Returns register bits int32[M, 32]."""
    level = 0
    while partial.shape[1] > 1:
        mat = torch.from_numpy(_crc_level_matrix(level)).to(partial.device)
        left = partial[:, 0::2].to(torch.float32)
        adv = (left @ mat.to(torch.float32)).to(torch.int32) & 1
        partial = adv ^ partial[:, 1::2]
        level += 1
    return partial[:, 0]


def back_aligned(data_2d: torch.Tensor, lengths) -> torch.Tensor:
    """uint8[M, P] rows, P a power-of-two multiple of CRC_CHUNK, holding
    row i's first ``lengths[i]`` bytes at their end: the reference's
    zero-prefixed buffer rolled by ``L - lengths[i]``, so bytes at and past
    ``lengths[i]`` wrap into the prefix and MUST be zero."""
    m, l = data_2d.shape
    p = _padded_len(l)
    dev = data_2d.device
    # rolled[i, j] = padded[i, (j - (l - len_i)) mod p], where padded holds
    # the row's l bytes at its end
    shift = l - torch.as_tensor(lengths, dtype=torch.int64).to(dev)
    col = torch.remainder(torch.arange(p, device=dev)[None, :] - shift[:, None], p)
    col = col - (p - l)
    rolled = torch.gather(data_2d, 1, col.clamp(0, l - 1))
    return torch.where(col >= 0, rolled, 0)


def crc32_rows_device(data_2d: torch.Tensor, lengths) -> torch.Tensor:
    """CRC-32 of each row's first ``lengths[i]`` bytes of a uint8[M, L]
    tensor (``lengths`` host integers or a tensor), on its device, left
    there: :func:`crc_cu.crc32_rows`, int64[M].  On the CPU (the plain
    version) bytes at and past ``lengths[i]`` MUST be zero; decoded
    payloads and member batches satisfy this."""
    if isinstance(lengths, torch.Tensor):
        lengths = lengths.to(data_2d.device, torch.int32)
    else:
        lengths = torch.from_numpy(np.asarray(lengths, np.int32)).to(data_2d.device)
    return crc_cu.crc32_rows(data_2d, lengths)


def crc32_batch_device(data_2d: torch.Tensor, lengths) -> np.ndarray:
    """:func:`crc32_rows_device` and one copy to the host; uint32[M] numpy."""
    return transfer.read_now(crc32_rows_device(data_2d, lengths)).astype(np.uint32)


def crc32_batch(data_2d: np.ndarray, lengths, *, device="cuda") -> np.ndarray:
    """CRC-32 of each row's first ``lengths[i]`` bytes of a host uint8[M, L]
    array, on ``device`` (:func:`crc_cu.crc32_rows`); bytes past a length
    may hold anything.  uint32[M] numpy, 0 for an empty row."""
    from .. import de

    dev = de._resolve_device(device)
    data_2d = np.asarray(data_2d, dtype=np.uint8)
    lens = np.asarray(lengths, np.int32)
    # bytes past each length are zeroed: the plain version reads them
    rows = np.where(np.arange(data_2d.shape[1])[None, :] < lens[:, None], data_2d, 0)
    return crc32_batch_device(torch.from_numpy(rows.astype(np.uint8)).to(dev), lens)


def crc32(data, value: int = 0, *, device="cuda") -> int:
    """CRC-32 of ``data`` on ``device``; drop-in for ``zlib.crc32``."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(
        data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8)
    if arr.size == 0:
        return value
    row = torch.from_numpy(arr.reshape(1, -1).copy()).to(device)
    lengths = torch.tensor([arr.size], dtype=torch.int32).to(device)
    init = torch.tensor([value & 0xFFFFFFFF], dtype=torch.int64).to(device)
    return int(crc_cu.crc32_rows(row, lengths, init)[0])


# ---------------------------------------------------------------------------
# Device Adler-32.
# ---------------------------------------------------------------------------


def _adler_partials(chunks: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """chunks: uint8[n, L]. Returns per-chunk (S, W) mod ADLER_MOD, int64,
    where S = Σ b and W = Σ (L-i)·b_i.  Both are summed in int32 straight
    from the bytes (W of one chunk < 255·L·(L+1)/2 < 2^31 for L = 512)."""
    l = chunks.shape[1]
    weights = l - torch.arange(l, device=chunks.device, dtype=torch.int32)
    s = chunks.sum(1, dtype=torch.int32) % ADLER_MOD
    w = (chunks * weights).sum(1, dtype=torch.int32) % ADLER_MOD
    return s.to(torch.int64), w.to(torch.int64)


def _adler32_padded(data_padded: torch.Tensor, length: int) -> torch.Tensor:
    """Adler-32 (from 1) of a back-aligned zero-front-padded uint8 buffer
    of a whole number of chunks, as an int64 scalar tensor.

    Leading zeros leave A unchanged and inflate B by exactly ``pad``
    (the padded buffer's leading 1s), corrected at the end."""
    p = data_padded.shape[0]
    nchunks = p // ADLER_CHUNK
    s, w = _adler_partials(data_padded.view(nchunks, ADLER_CHUNK))
    # B(padded) = P + Σ_j W_j + L·Σ_j (n-1-j)·S_j  (mod m); A = 1 + Σ S_j
    coeff = (nchunks - 1 - torch.arange(nchunks, device=s.device)) % ADLER_MOD
    weighted = (coeff * s) % ADLER_MOD  # < 2^32: int64 holds it
    a = (1 + s.sum()) % ADLER_MOD
    b = (p % ADLER_MOD + w.sum() + ADLER_CHUNK * (weighted.sum() % ADLER_MOD)) % ADLER_MOD
    b = (b - (p - length) % ADLER_MOD + ADLER_MOD) % ADLER_MOD
    return (b << 16) | a


def adler32(data, value: int = 1, *, device="cuda") -> int:
    """Adler-32 of ``data`` on ``device`` (a tensor stays on its own
    device); drop-in for ``zlib.adler32``."""
    if isinstance(data, torch.Tensor):
        t = data.reshape(-1)
    else:
        arr = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(
            data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8)
        if not arr.flags.writeable:  # torch wants a writable buffer
            arr = arr.copy()
        t = torch.from_numpy(arr.reshape(-1)).to(device)
    if t.dtype != torch.uint8:
        raise TypeError(f"adler32: expected uint8 data, got {t.dtype}")
    n = t.shape[0]
    if n == 0:
        return value
    pad = -n % ADLER_CHUNK
    padded = torch.cat([t.new_zeros(pad), t]) if pad else t
    fresh = int(_adler32_padded(padded, n))
    if value == 1:
        return fresh
    return adler32_combine(value, fresh, n)
