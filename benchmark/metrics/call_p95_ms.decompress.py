"""95th percentile of the wall time of a decompression call, over every call
of the traced window (host clock)."""

from benchmark import readers

UNIT = "ms"


def read(ctx: dict) -> float | None:
    return readers.call_p95_ms(ctx) if ctx["kind"] == "decompress" else None
