#!/usr/bin/env python3
"""The compressors' two native host stages on the card machine's host:
each batch's time and the stage's counter.

    python3 scripts/torch_plan_split.py [RUNS] [STAGE ...]

STAGE is ``plan`` (``de.plan_blocks``, counter ``de.PLAN_COUNTS``) or
``tables`` (``lz77._cost_tables_host``, counter ``lz77.TABLE_COUNTS``);
both by default.  On the benchmark's inputs (``benchmark/inputs.py``,
seed 1: the Calgary corpus cut to 8 MiB for the one-shot and to 16 MiB
for the archive), one warm call of ``gz.compress(x, 6)`` and one of
``sharded_gzip_compress(x, 6)`` on the card record every call of the
stage's arguments and the growth of its counter.  Then RUNS (default 20)
rounds run each recorded batch through the stage again, on
``time.perf_counter``, and check every result equal to the first.
(The stages' Python models are the reference's, which the CPU tests hold
them to.)  Prints the card's name and power limit and one JSON line
last.  Exits 2 without CUDA.
"""

from __future__ import annotations

import collections
import json
import pathlib
import statistics
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent.parent


def _stages():
    """stage -> (module, function name, counter, counter keys)"""
    from decompress_tpu_torch import de
    from decompress_tpu_torch.ops import lz77

    return {
        "plan": (de, "plan_blocks", de.PLAN_COUNTS, ("stored", "fixed", "dynamic", "overflow")),
        "tables": (lz77, "_cost_tables_host", lz77.TABLE_COUNTS, ("rows", "overflow")),
    }


def _record(mod, name, counter, keys, fn):
    """Run ``fn`` with ``mod.<name>`` recording its calls; returns the
    calls (args, kwargs) and the counter's growth."""
    calls = []
    native = getattr(mod, name)

    def recording(*args, **kwargs):
        calls.append(([a.copy() if hasattr(a, "copy") else a for a in args], dict(kwargs)))
        return native(*args, **kwargs)

    before = collections.Counter(counter)
    setattr(mod, name, recording)
    try:
        fn()
    finally:
        setattr(mod, name, native)
    return calls, {k: counter[k] - before[k] for k in keys}


def _same(a, b) -> bool:
    """Equal results of either stage: arrays by dtype and value, the rest
    (the planner's kinds) by ``==``, through nested tuples."""
    import numpy as np

    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_plan_split: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    runs = int(args.pop(0)) if args and args[0].isdigit() else 20
    sys.path.insert(0, str(HERE))
    import chip_smoke  # the card line
    from benchmark import inputs
    from decompress_tpu_torch import gz
    from decompress_tpu_torch.parallel import sharded

    stages = _stages()
    chosen = args or list(stages)
    card = chip_smoke.card_line()
    print(card, flush=True)
    one_shot = inputs.make_inputs("calgary", 8 << 20, 1, 1)[0]
    archive = inputs.make_inputs("calgary", 16 << 20, 1, 1)[0]
    paths = {"gz6-8m": (lambda: gz.compress(one_shot, 6), len(one_shot)),
             "archive6-16m-write": (lambda: sharded.sharded_gzip_compress(archive, 6),
                                    len(archive))}
    out = {"card": card, "runs": runs}
    ok = True
    for stage in chosen:
        mod, name, counter, keys = stages[stage]
        for path, (fn, n_bytes) in paths.items():
            fn()  # warm: builds, captures
            torch.cuda.synchronize()
            calls, counts = _record(mod, name, counter, keys, fn)
            torch.cuda.synchronize()
            mb = n_bytes / 1e6
            f = getattr(mod, name)
            times, first, equal = [], None, True
            for _ in range(runs):
                t0 = time.perf_counter()
                res = [f(*a, **kw) for a, kw in calls]
                times.append(time.perf_counter() - t0)
                first = res if first is None else first
                equal = equal and all(_same(a, b) for a, b in zip(res, first))
            ok = ok and equal
            row = {"batches": len(calls), "rows": sum(len(a[0]) for a, _ in calls),
                   "MB": mb, "counts": counts, "equal": equal}
            med = statistics.median(times)
            row["native_ms_per_batch"] = 1e3 * med / len(calls)
            row["native_ms_per_MB"] = 1e3 * med / mb
            row["native_ms_per_batch_quartiles"] = [
                1e3 * q / len(calls) for q in statistics.quantiles(times, n=4)]
            out[f"{stage}.{path}"] = row
            print(stage, path, json.dumps(row), flush=True)
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
