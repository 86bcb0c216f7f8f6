"""Captured programs: replays in the window (the program's
``graphs.REPLAYS``, all programs), per MB of input compressed."""

from benchmark import program_spans

UNIT = "1/MB"
program_spans.arm()


def read(ctx: dict) -> float | None:
    if ctx["kind"] != "compress":
        return None
    return program_spans.per_mb(ctx, "replays")
