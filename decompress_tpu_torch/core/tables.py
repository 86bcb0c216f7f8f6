"""Copy of ``decompress_tpu/core/tables.py``: the port imports nothing of
the reference package; ``tests/test_torch_core.py`` holds the copy equal.

Static DEFLATE constant tables (RFC 1951 §3.2.5–3.2.6).

Numpy constants used by both the host code and the device kernels.
Parity with the reference's static tables: length→code map
(de.ml:240–256), distance→code two-half table (de.ml:258–291), base
lengths/distances + extra-bit counts (de.ml:293–325), fixed Huffman
lit/dist code lengths (de.ml:373–420), and the zigzag precode order
(de.ml:237–238) of mirage/decompress.

All tables here are *derived from the RFC*, not copied: they are fully
determined by the DEFLATE specification.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Length codes 257..285 (RFC 1951 §3.2.5).
# ---------------------------------------------------------------------------

#: Base match length for each of the 29 length codes (code 257 + i).
LENGTH_BASE = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51,
     59, 67, 83, 99, 115, 131, 163, 195, 227, 258],
    dtype=np.int32,
)

#: Extra bits for each length code.
LENGTH_EXTRA = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4,
     4, 5, 5, 5, 5, 0],
    dtype=np.int32,
)

# ---------------------------------------------------------------------------
# Distance codes 0..29 (RFC 1951 §3.2.5).
# ---------------------------------------------------------------------------

#: Base distance for each of the 30 distance codes.
DIST_BASE = np.array(
    [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385,
     513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385,
     24577],
    dtype=np.int32,
)

#: Extra bits for each distance code.
DIST_EXTRA = np.array(
    [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10,
     10, 11, 11, 12, 12, 13, 13],
    dtype=np.int32,
)

# ---------------------------------------------------------------------------
# Encoder-side lookup maps (analogues of de.ml:240–291).
# ---------------------------------------------------------------------------


def _make_length_code_map() -> np.ndarray:
    """256-entry table: match length l (3..258) -> length code index 0..28.

    Indexed by ``l - 3``; the analogue of the reference's `_length` table
    (de.ml:240–256) but derived from LENGTH_BASE/LENGTH_EXTRA.
    """
    out = np.zeros(256, dtype=np.int32)
    for code in range(29):
        base = int(LENGTH_BASE[code])
        span = 1 << int(LENGTH_EXTRA[code])
        hi = min(base + span, 259) if code != 28 else 259
        out[base - 3 : hi - 3] = code
    out[258 - 3] = 28  # length 258 uses code 285 (no extra bits)
    return out


def _make_dist_code_map() -> np.ndarray:
    """512-entry two-half table mapping a distance to its code.

    ``DIST_CODE_MAP[d - 1]`` for d <= 256, ``DIST_CODE_MAP[256 + ((d-1) >> 7)]``
    for d > 256 — the classic zlib layout (reference de.ml:258–291).
    """
    out = np.zeros(512, dtype=np.int32)
    for d in range(1, 257):
        code = int(np.searchsorted(DIST_BASE, d, side="right") - 1)
        out[d - 1] = code
    for idx in range(256, 512):
        # smallest distance with (d-1)>>7 == idx-256; all 128 distances in
        # that bucket share a code because every code >= 16 (d >= 257)
        # spans at least 128 distances.
        d = ((idx - 256) << 7) + 1
        code = int(np.searchsorted(DIST_BASE, d, side="right") - 1)
        out[idx] = code
    return out


LENGTH_CODE_MAP = _make_length_code_map()
DIST_CODE_MAP = _make_dist_code_map()


def length_to_code(length: np.ndarray) -> np.ndarray:
    """Vectorized match-length -> length-code (0..28)."""
    return LENGTH_CODE_MAP[np.asarray(length) - 3]


def dist_to_code(dist: np.ndarray) -> np.ndarray:
    """Vectorized distance -> distance-code (0..29)."""
    d = np.asarray(dist)
    idx = np.where(d <= 256, np.clip(d - 1, 0, 255), 256 + ((d - 1) >> 7))
    return DIST_CODE_MAP[idx]


# ---------------------------------------------------------------------------
# Fixed Huffman code lengths (RFC 1951 §3.2.6; reference de.ml:373–420).
# ---------------------------------------------------------------------------

FIXED_LIT_LENGTHS = np.concatenate(
    [
        np.full(144, 8, dtype=np.int32),   # 0..143
        np.full(112, 9, dtype=np.int32),   # 144..255
        np.full(24, 7, dtype=np.int32),    # 256..279
        np.full(8, 8, dtype=np.int32),     # 280..287
    ]
)

# 32 five-bit codes: 30–31 are reserved (never emitted) but participate in
# the code space so the tree is complete (RFC 1951 §3.2.6).
FIXED_DIST_LENGTHS = np.full(32, 5, dtype=np.int32)

#: Order in which precode (code-length code) lengths are stored in a
#: dynamic block header (RFC 1951 §3.2.7; reference's zigzag de.ml:237–238).
PRECODE_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    dtype=np.int32,
)

#: Alphabet sizes.
NUM_LIT_SYMS = 286      # literals 0..255, EOB 256, length codes 257..285
NUM_DIST_SYMS = 30
NUM_PRECODE_SYMS = 19
MAX_BITS = 15           # max Huffman code length in DEFLATE
MAX_PRECODE_BITS = 7
MIN_MATCH = 3
MAX_MATCH = 258
WINDOW_SIZE = 1 << 15   # 32 KiB DEFLATE window
EOB = 256


def reverse_bits(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Bit-reverse each code within its own length (vectorized).

    DEFLATE writes Huffman codes LSB-first, so canonical (MSB-first) codes
    must be reversed before emission (reference `reverse_code`
    de.ml:1926–1950 does this one code at a time; here it is one vector op).
    """
    codes = np.asarray(codes, dtype=np.uint32)
    lengths = np.asarray(lengths, dtype=np.int32)
    v = codes
    r = np.zeros_like(v)
    for _ in range(MAX_BITS):
        r = (r << 1) | (v & 1)
        v = v >> 1
    # r now holds the MAX_BITS-wide reversal; shift down to the code's width
    rev = (r >> (MAX_BITS - np.maximum(lengths, 1))).astype(np.uint32)
    return np.where(lengths > 0, rev, np.uint32(0))
