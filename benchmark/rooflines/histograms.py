"""``hist_cu.histograms`` (``hist_kernel``), two launches a batch (rounds
A and B).  Bytes: on-path and match flags (bool), length and distance
(int32) and the literals (uint8), each [seg], read once; the literal and
distance histograms (int32[286] and [30]) written once."""

NAMES = ("hist_kernel",)
LAUNCHES = 2
LEVELS = (6,)


def bytes_per_launch(rows: int, t: int, seg: int) -> int:
    return rows * ((1 + 1 + 4 + 4 + 1) * seg + 4 * (286 + 30))
