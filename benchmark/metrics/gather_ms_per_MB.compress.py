"""The processes' exchange: wall time inside ``multihost._all_gather``
(the harness's span: the gloo all-gathers of the pieces' sizes, the
pieces and the index metadata), summed over the processes, per MB of
input compressed."""

from benchmark import readers

UNIT = "ms/MB"
SPANS = {"all_gather": ["decompress_tpu_torch.parallel.multihost:_all_gather"]}


def read(ctx: dict) -> float | None:
    return readers.span_ms_per_mb(ctx, SPANS, cpu=False)
