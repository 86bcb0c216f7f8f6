"""Compressed bytes over input bytes, over every call of the window."""

UNIT = "out/in"


def read(ctx: dict) -> float | None:
    if ctx["kind"] != "compress":
        return None
    return ctx["bytes_out"] / ctx["bytes_in"]
