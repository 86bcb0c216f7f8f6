"""The decode's host plan: the CPU time of the calling thread inside
``sharded.decode_plan`` (the harness's span), per MB decoded."""

from benchmark import readers

UNIT = "ms/MB"
SPANS = {"decode_plan": ["decompress_tpu_torch.parallel.sharded:decode_plan"]}


def read(ctx: dict) -> float | None:
    return readers.span_ms_per_mb(ctx, SPANS, cpu=True)
