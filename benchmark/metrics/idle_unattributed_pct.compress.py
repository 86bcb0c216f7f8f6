"""Share of the window's device-idle time that lies inside a ``call``
span of the program but under no other of its spans, in %: idle time no
layer's span accounts for."""

from benchmark import program_spans

UNIT = "%"
program_spans.arm()


def read(ctx: dict) -> float | None:
    return program_spans.unattributed_pct(ctx) if ctx["kind"] == "compress" else None
