"""``parse_cu.mark_path`` (``chunk_exit_kernel``, ``chunk_hop_kernel``,
``chunk_refine_kernel``), two launches a batch (round A's parse and round
B's).  Bytes: the jump array (int32[p], p the power of two at or above
seg) read once, the on-path flags (bool[p]) written once."""

NAMES = ("chunk_exit_kernel", "chunk_hop_kernel", "chunk_refine_kernel")
LAUNCHES = 2
LEVELS = (6,)


def bytes_per_launch(rows: int, t: int, seg: int) -> int:
    p = 1 << (seg - 1).bit_length()
    return rows * p * (4 + 1)
