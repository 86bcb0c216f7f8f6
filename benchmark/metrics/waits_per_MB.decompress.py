"""Transfers: the host's waits on the card in the window (the program's
``transfer.COUNTS["waits"]``: event waits and blocking reads), per
MB decoded."""

from benchmark import program_spans

UNIT = "1/MB"
program_spans.arm()


def read(ctx: dict) -> float | None:
    if ctx["kind"] != "decompress":
        return None
    return program_spans.per_mb(ctx, "waits")
