"""``probe_cu.probe`` (``probe_kernel``), one launch a batch in round A.
Bytes: the sorted keys (int64) and the records by their fields (8 of 4
bytes) read once, each row's valid bounds (2 int64), the packed winners
(int64[seg]) written once."""

NAMES = ("probe_kernel",)
LAUNCHES = 1
LEVELS = (6,)


def bytes_per_launch(rows: int, t: int, seg: int) -> int:
    return rows * (t * (8 + 4 * 8) + 8 * seg + 16)
