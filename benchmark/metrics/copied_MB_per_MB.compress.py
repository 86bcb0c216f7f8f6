"""Transfers: bytes copied between the host and the card in the window
(the program's ``transfer.COUNTS``: ``uploaded``, pinned and pageable,
and ``fetched``), in MB per MB of input compressed."""

from benchmark import program_spans

UNIT = "MB/MB"
program_spans.arm()


def read(ctx: dict) -> float | None:
    if ctx["kind"] != "compress":
        return None
    mb = program_spans.per_mb(ctx, "uploaded", "fetched")
    return mb / 1e6 if mb is not None else None
