"""The processes' wait for the slowest: wall time inside
``multihost._gather_sizes`` (the harness's span: the all-gather of the
pieces' sizes, 8 bytes a process and the first collective of a call, so
its time is the wait for the process that finishes its members last),
summed over the processes, per MB of input compressed.  A program whose
exchange has no ``_gather_sizes`` (an older checkout) gets no span, and
the metric reads nothing."""

from benchmark import readers
from decompress_tpu_torch.parallel import multihost

UNIT = "ms/MB"
SPANS = ({"rank_wait": ["decompress_tpu_torch.parallel.multihost:_gather_sizes"]}
         if hasattr(multihost, "_gather_sizes") else {})


def read(ctx: dict) -> float | None:
    return readers.span_ms_per_mb(ctx, SPANS, cpu=False)
