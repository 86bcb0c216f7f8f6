"""Compression rate: input bytes of every call of the window (on several
cards, the calls are collective), over the time from the window's start
to the end of the last of those calls, in MB (10**6 bytes) a second
(host clock)."""

from benchmark import readers

UNIT = "MB/s"


def read(ctx: dict) -> float | None:
    return readers.rate_mbps(ctx) if ctx["kind"] == "compress" else None
