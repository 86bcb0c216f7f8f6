"""Share of the traced window in which no kernel or copy ran on the
card (the profiler's device events, merged), in %."""

from benchmark import readers

UNIT = "%"


def read(ctx: dict) -> float | None:
    return readers.idle_pct(ctx) if ctx["kind"] == "compress" else None
