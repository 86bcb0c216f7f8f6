"""The processes' index rebuild: wall time inside
``multihost._assemble_index`` (the harness's span: every process's
metadata rows unpacked, the archive's TZ/TB index built from them and
joined to the first member's header, in every process), summed over the
processes, per MB of input compressed.  A program whose exchange has no
``_assemble_index`` (an older checkout) gets no span, and the metric
reads nothing."""

from benchmark import readers
from decompress_tpu_torch.parallel import multihost

UNIT = "ms/MB"
SPANS = ({"exchange_index": ["decompress_tpu_torch.parallel.multihost:_assemble_index"]}
         if hasattr(multihost, "_assemble_index") else {})


def read(ctx: dict) -> float | None:
    return readers.span_ms_per_mb(ctx, SPANS, cpu=False)
