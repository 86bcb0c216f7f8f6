"""Set-up time: from the process's start until the window opens, every
input run once (host clock)."""

UNIT = "s"


def read(ctx: dict) -> float:
    return ctx["setup_s"]
