"""``crc_cu.crc32_rows`` (``crc_rows_kernel``), one launch a chunk of
archive members.  Bytes: the member bytes (uint8[seg]) and their lengths
(int32) read once, the CRC-32s (int64) written once."""

NAMES = ("crc_rows_kernel",)
LAUNCHES = 1
LEVELS = (6,)


def bytes_per_launch(rows: int, t: int, seg: int) -> int:
    return rows * (seg + 4 + 8)
