"""The schedule's host work: wall time in the self intervals of the
program's ``schedule.stage`` (building a batch's or chunk's arrays) and
``schedule.assemble`` (assembling the output) spans, per MB of input
compressed."""

from benchmark import program_spans

UNIT = "ms/MB"
program_spans.arm()


def read(ctx: dict) -> float | None:
    if ctx["kind"] != "compress":
        return None
    return program_spans.ms_per_mb(
        ctx, lambda name: name in ("schedule.stage", "schedule.assemble"))
