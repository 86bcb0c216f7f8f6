"""Round B's host tables: the CPU time of the calling thread inside
``lz77._cost_tables_host`` and ``lz77._hot_dists_host`` (the harness's
spans), summed over the processes, per MB of input compressed."""

from benchmark import readers

UNIT = "ms/MB"
SPANS = {"cost_tables": ["decompress_tpu_torch.ops.lz77:_cost_tables_host"],
         "hot_dists": ["decompress_tpu_torch.ops.lz77:_hot_dists_host"]}


def read(ctx: dict) -> float | None:
    return readers.span_ms_per_mb(ctx, SPANS, cpu=True)
