"""The compression kernels' share of their roofline: the least time the
port's kernels' work needs (the bytes each launch must move at the
cell's shapes, ``rooflines/<kernel>.py``, over the card's memory
bandwidth) over those kernels' device time in the traced window, in %.

A call's batches (rows, row bytes, segment bytes) follow from its input
size (the entry's ``batches``); each kernel's bytes are its launches'
count from those, scaled to the launches the trace holds (a repair adds
launches), over every call of the window.  A kernel listed for the cell
with no launch in the traced window fails the run."""

from benchmark import readers, spec
from benchmark.rooflines import _peaks

UNIT = "%"


def read(ctx: dict) -> float | None:
    if ctx["kind"] != "compress" or "device" not in ctx or not ctx["batches"]:
        return None
    least_s = busy_s = 0.0
    for kernel in ctx["kernels"]:
        roof = spec.load_module("rooflines", kernel)
        if ctx["level"] not in roof.LEVELS:  # shapes this file does not hold
            return None
        expected = sum(roof.LAUNCHES for _ in ctx["batches"])
        moved = sum(roof.LAUNCHES * roof.bytes_per_launch(*b) for b in ctx["batches"])
        _, seen = readers.kernel_seconds(ctx, lambda n: readers.named(n, roof.NAMES[:1]))
        secs, _ = readers.kernel_seconds(ctx, lambda n: readers.named(n, roof.NAMES))
        if seen == 0:  # renamed, or taken off the path: the ratio would shift unseen
            raise RuntimeError(f"kernel {kernel} ({roof.NAMES[0]}) has no launch in the "
                               "traced window")
        least_s += moved * seen / expected / _peaks.HBM_BYTES_PER_S
        busy_s += secs
    if busy_s == 0:
        return None
    return 100.0 * least_s / busy_s
