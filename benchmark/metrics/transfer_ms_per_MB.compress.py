"""Transfers: wall time in the self intervals of the program's
``transfer.*`` spans (uploads, queued fetches, the host's waits on the
card), per MB of input compressed."""

from benchmark import program_spans

UNIT = "ms/MB"
program_spans.arm()


def read(ctx: dict) -> float | None:
    if ctx["kind"] != "compress":
        return None
    return program_spans.ms_per_mb(ctx, lambda name: name.startswith("transfer."))
