"""Transfers: wall time in the self intervals of the program's
``transfer.*`` spans (pageable uploads, blocking reads), per MB
decoded."""

from benchmark import program_spans

UNIT = "ms/MB"
program_spans.arm()


def read(ctx: dict) -> float | None:
    if ctx["kind"] != "decompress":
        return None
    return program_spans.ms_per_mb(ctx, lambda name: name.startswith("transfer."))
