"""``pack_cu.build_slots`` (``slots_kernel``), one launch a batch in the
pack.  Bytes: on-path and match flags (bool), length and distance
(int32), the literals (uint8), each [seg], and the code tables
(int32[286] and [30]) read once; the four slot planes (int32[seg] each)
written once."""

NAMES = ("slots_kernel",)
LAUNCHES = 1
LEVELS = (6,)


def bytes_per_launch(rows: int, t: int, seg: int) -> int:
    return rows * ((1 + 1 + 4 + 4 + 1) * seg + 4 * (286 + 30) + 4 * 4 * seg)
