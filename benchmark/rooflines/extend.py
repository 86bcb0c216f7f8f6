"""``probe_cu.extend`` (``extend_kernel``), one launch a batch in round A.
Bytes: the words (int64[t]), the packed winners, the hash3 candidates
(int64[seg] each), the capped runs (int32[4, seg]) and the row bounds (2
int64) read once; length and distance (int32[seg] each) written once."""

NAMES = ("extend_kernel",)
LAUNCHES = 1
LEVELS = (6,)


def bytes_per_launch(rows: int, t: int, seg: int) -> int:
    return rows * (8 * t + (8 + 8 + 16) * seg + 16 + (4 + 4) * seg)
