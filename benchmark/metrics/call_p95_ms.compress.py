"""95th percentile of the wall time of a compression call, over every call
of the traced window (host clock)."""

from benchmark import readers

UNIT = "ms"


def read(ctx: dict) -> float | None:
    return readers.call_p95_ms(ctx) if ctx["kind"] == "compress" else None
