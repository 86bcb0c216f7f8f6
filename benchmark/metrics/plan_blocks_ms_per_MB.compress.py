"""Host block planning: the CPU time of the calling thread inside
``de.plan_blocks`` (the harness's span), summed over the processes, per MB
of input compressed."""

from benchmark import readers

UNIT = "ms/MB"
SPANS = {"plan_blocks": ["decompress_tpu_torch.de:plan_blocks"]}


def read(ctx: dict) -> float | None:
    return readers.span_ms_per_mb(ctx, SPANS, cpu=True)
