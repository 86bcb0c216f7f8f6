"""``cost_cu.litbits_pref`` (``litbits_tally_kernel``,
``litbits_scan_kernel``), one launch a batch in round B.  Bytes: the
literals (uint8[seg]) and the literal costs (int32[286]) read once; the
bits (int32[seg]) and their prefix (int32[seg + 1]) written once."""

NAMES = ("litbits_tally_kernel", "litbits_scan_kernel")
LAUNCHES = 1
LEVELS = (6,)


def bytes_per_launch(rows: int, t: int, seg: int) -> int:
    return rows * (seg + 4 * 286 + 4 * seg + 4 * (seg + 1))
