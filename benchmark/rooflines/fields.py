"""``probe_cu.fields`` (``csrc/probe.cu`` ``fields_kernel``), one launch a
batch in round A.  Bytes: the row bytes read once; the word and key
(int64) written once; the probe records counted by the fields a record
holds (8 of 4 bytes at a full-ladder level, as ``chip_smoke.py``'s
``record_bytes``); the capped runs (int32[4, seg]) written once."""

NAMES = ("fields_kernel",)
LAUNCHES = 1
#: the levels these shapes hold for: full ladder, runs, hash3, rec mode
LEVELS = (6,)


def bytes_per_launch(rows: int, t: int, seg: int) -> int:
    return rows * (t * (1 + 8 + 8 + 4 * 8) + 4 * 4 * seg)
