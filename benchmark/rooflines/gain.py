"""``cost_cu.gain`` (``gain_kernel``), one launch a batch in round B.
Bytes: length and distance (int32[seg]), the literal bits' prefix
(int32[seg + 1]) and the cost tables (int32[286] and [30]) read once;
length, distance and gain (int32[seg] each) written once.  The hot lane's
two int32[seg] inputs, read where round B mines hot strides, are left
out, so the count is the least any launch moves."""

NAMES = ("gain_kernel",)
LAUNCHES = 1
LEVELS = (6,)


def bytes_per_launch(rows: int, t: int, seg: int) -> int:
    return rows * (4 * seg + 4 * seg + 4 * (seg + 1) + 4 * (286 + 30) + 3 * 4 * seg)
