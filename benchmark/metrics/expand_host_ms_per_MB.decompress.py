"""The decode's host expansion: the CPU time of the calling thread inside
``sharded._expand_native`` (the harness's span: the compacted commands'
fetch, the native expansion and CRC-32 of each member), per MB decoded."""

from benchmark import readers

UNIT = "ms/MB"
SPANS = {"expand_native": ["decompress_tpu_torch.parallel.sharded:_expand_native"]}


def read(ctx: dict) -> float | None:
    return readers.span_ms_per_mb(ctx, SPANS, cpu=True)
