"""Copy of ``decompress_tpu/core/bitstream.py``: the port imports nothing of
the reference package; ``tests/test_torch_core.py`` holds the copy equal.

Host-side bit-level I/O for DEFLATE streams.

DEFLATE packs bits LSB-first within bytes (RFC 1951 §3.1.1).  The hot
encode path on device uses the two-pass pack (per-symbol bit lengths →
exclusive scan → disjoint scatter-OR); :func:`pack_bits` is the
vectorized host analogue and the test oracle for the device kernel
(``decompress_tpu.ops.bitpack``).  ``BitWriter``/``BitReader`` serve
header/trailer framing and the streaming engines (the role of the
reference's `c_bits` packer de.ml:2529–2541 and the `hold`/`bits`
reader de.ml:651–672).
"""

from __future__ import annotations

import numpy as np


def pack_bits(values: np.ndarray, nbits: np.ndarray, *, bit_offset: int = 0) -> tuple[np.ndarray, int]:
    """Pack ``values[i]`` (low ``nbits[i]`` bits, LSB-first) into a byte array.

    Each element must satisfy ``nbits[i] <= 31``.  Returns
    ``(bytes_uint8, total_bits)`` where total_bits includes ``bit_offset``
    leading zero bits (useful for appending to a partially filled byte).

    Fully vectorized: exclusive-scan of bit lengths gives every element's
    bit position; each element contributes to at most two 32-bit words,
    and contributions are bit-disjoint so scatter-add == scatter-OR.
    """
    values = np.asarray(values, dtype=np.uint64)
    nbits = np.asarray(nbits, dtype=np.int64)
    if np.any(nbits > 31) or np.any(nbits < 0):
        raise ValueError("pack_bits supports 0..31 bits per element")
    offsets = bit_offset + np.concatenate([[0], np.cumsum(nbits)[:-1]])
    total = int(bit_offset + nbits.sum())
    nz = nbits > 0
    if not nz.all():  # zero-width slots are common (literal commands)
        values, nbits, offsets = values[nz], nbits[nz], offsets[nz]
    nwords = (total >> 5) + 2
    masked = values & ((np.uint64(1) << nbits.astype(np.uint64)) - np.uint64(1))
    widx = offsets >> 5
    shift = (offsets & 31).astype(np.uint64)
    shifted = masked << shift  # <= 31+31 = 62 bits, fits uint64
    # scatter-OR == scatter-ADD (bit-disjoint); bincount with float64
    # weights is exact (each word receives <= 32 bits -> sums < 2^32)
    # and much faster than np.add.at
    lo = np.bincount(widx, weights=(shifted & np.uint64(0xFFFFFFFF)).astype(np.float64),
                     minlength=nwords)
    hi = np.bincount(widx + 1, weights=(shifted >> np.uint64(32)).astype(np.float64),
                     minlength=nwords)
    words = (lo + hi).astype(np.uint64)
    out = words.astype(np.uint32).view(np.uint8)  # little-endian words == LSB-first stream
    return out[: (total + 7) // 8].copy(), total


class BitWriter:
    """Incremental LSB-first bit writer (host framing / headers)."""

    def __init__(self) -> None:
        self._chunks: list[np.ndarray] = []
        self._hold = 0
        self._nbits = 0  # bits currently in _hold (0..7 after flushes)

    @property
    def bit_length(self) -> int:
        return sum(c.size for c in self._chunks) * 8 + self._nbits

    def write(self, value: int, nbits: int) -> None:
        self._hold |= (value & ((1 << nbits) - 1)) << self._nbits
        self._nbits += nbits
        while self._nbits >= 8:
            self._chunks.append(np.array([self._hold & 0xFF], dtype=np.uint8))
            self._hold >>= 8
            self._nbits -= 8

    def align_to_byte(self) -> None:
        if self._nbits:
            self._chunks.append(np.array([self._hold & 0xFF], dtype=np.uint8))
            self._hold = 0
            self._nbits = 0

    def write_bytes(self, data: bytes | np.ndarray) -> None:
        """Write whole bytes; the cursor must be byte-aligned."""
        if self._nbits:
            raise ValueError("write_bytes requires byte alignment")
        arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
        self._chunks.append(arr)

    def write_packed(self, packed: np.ndarray, total_bits: int) -> None:
        """Append a pre-packed bit run produced by :func:`pack_bits`.

        If the cursor is byte-aligned this is a plain byte append; otherwise
        the packed buffer is re-aligned with one vectorized shift.
        """
        if total_bits == 0:
            return
        r = self._nbits
        if r == 0:
            nfull, rem = divmod(total_bits, 8)
            self._chunks.append(packed[:nfull])
            if rem:
                self._hold = int(packed[nfull])
                self._nbits = rem
            return
        # shift packed left by r bits: out[i] = packed[i]<<r | packed[i-1]>>(8-r)
        p16 = packed.astype(np.uint16)
        shifted = (p16 << r) & 0xFF
        carry = np.concatenate([[np.uint16(self._hold)], (p16 >> (8 - r))])
        merged = np.concatenate([shifted, [np.uint16(0)]]) | carry
        new_total = r + total_bits
        nfull, rem = divmod(new_total, 8)
        merged8 = merged.astype(np.uint8)
        self._chunks.append(merged8[:nfull])
        self._hold = int(merged8[nfull]) if rem else 0
        self._nbits = rem

    def getvalue(self) -> bytes:
        self.align_to_byte()
        if not self._chunks:
            return b""
        return np.concatenate(self._chunks).tobytes()

    def take_bytes(self) -> bytes:
        """Drain the whole bytes accumulated so far, keeping the partial
        bit state (streaming emission without forcing alignment)."""
        if not self._chunks:
            return b""
        out = np.concatenate(self._chunks).tobytes()
        self._chunks = []
        return out


class BitReader:
    """LSB-first bit reader over a byte buffer (host parse paths).

    Mirrors the reference decoder's hold/bits discipline (de.ml:651–672)
    including "give back" of whole unconsumed bytes at end of stream
    (de.ml:1459–1466) via :meth:`byte_position`.
    """

    def __init__(self, data: bytes | np.ndarray) -> None:
        self.data = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8)
        self.pos = 0          # next byte to load into hold
        self.hold = 0
        self.nbits = 0

    def _fill(self, need: int) -> bool:
        while self.nbits < need:
            if self.pos >= self.data.size:
                return False
            self.hold |= int(self.data[self.pos]) << self.nbits
            self.pos += 1
            self.nbits += 8
        return True

    def peek(self, n: int) -> int:
        """Peek up to n bits; missing high bits read as 0 (end of input)."""
        self._fill(n)
        return self.hold & ((1 << n) - 1)

    def available(self) -> int:
        return self.nbits + 8 * (self.data.size - self.pos)

    def consume(self, n: int) -> None:
        if not self._fill(n):
            raise EOFError("bit reader exhausted")
        self.hold >>= n
        self.nbits -= n

    def read(self, n: int) -> int:
        v = self.peek(n)
        if self.nbits < n:
            raise EOFError("bit reader exhausted")
        self.consume(n)
        return v

    def align_to_byte(self) -> None:
        drop = self.nbits & 7
        self.hold >>= drop
        self.nbits -= drop

    def read_bytes(self, n: int) -> np.ndarray:
        """Read n whole bytes (cursor must be byte-aligned)."""
        if self.nbits & 7:
            raise ValueError("read_bytes requires byte alignment")
        out = np.empty(n, dtype=np.uint8)
        k = 0
        while self.nbits >= 8 and k < n:
            out[k] = self.hold & 0xFF
            self.hold >>= 8
            self.nbits -= 8
            k += 1
        rest = n - k
        if rest > self.data.size - self.pos:
            raise EOFError("bit reader exhausted")
        out[k:] = self.data[self.pos : self.pos + rest]
        self.pos += rest
        return out

    def byte_position(self) -> int:
        """Byte offset of the first byte not consumed, after giving back
        whole bytes still sitting in the hold."""
        return self.pos - (self.nbits // 8)
