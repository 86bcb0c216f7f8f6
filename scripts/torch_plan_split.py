#!/usr/bin/env python3
"""The host block planner on the card machine's host: each batch's
planning time, native (``de.plan_blocks``) against the plain Python
planner (``de._plan_blocks_plain``), and the rows planned by kind.

    python3 scripts/torch_plan_split.py [RUNS]

On the benchmark's inputs (``benchmark/inputs.py``, seed 1: the Calgary
corpus cut to 8 MiB for the one-shot and to 16 MiB for the archive), one
warm call of ``gz.compress(x, 6)`` and one of
``sharded_gzip_compress(x, 6)`` on the card record every ``plan_blocks``
call's arguments and the growth of ``de.PLAN_COUNTS``.  Then RUNS
(default 20) rounds plan each recorded batch with both planners in turns,
on ``time.perf_counter``, and check the two equal.  Prints the card's
name and power limit and one JSON line last.  Exits 2 without CUDA.
"""

from __future__ import annotations

import collections
import json
import pathlib
import statistics
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent.parent


def _record(de, fn):
    """Run ``fn`` with ``de.plan_blocks`` recording its calls; returns the
    calls (args, kwargs) and ``PLAN_COUNTS``' growth."""
    calls = []
    native = de.plan_blocks

    def recording(*args, **kwargs):
        calls.append(([a.copy() if hasattr(a, "copy") else a for a in args], dict(kwargs)))
        return native(*args, **kwargs)

    before = collections.Counter(de.PLAN_COUNTS)
    de.plan_blocks = recording
    try:
        fn()
    finally:
        de.plan_blocks = native
    grown = {k: de.PLAN_COUNTS[k] - before[k] for k in ("stored", "fixed", "dynamic",
                                                        "overflow")}
    return calls, grown


def _same(a, b) -> bool:
    import numpy as np

    return a[2] == b[2] and all(x.dtype == y.dtype and np.array_equal(x, y)
                                for x, y in zip((*a[0], *a[1]), (*b[0], *b[1])))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_plan_split: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    sys.path.insert(0, str(HERE))
    import chip_smoke  # the card line
    from benchmark import inputs
    from decompress_tpu_torch import de, gz
    from decompress_tpu_torch.parallel import sharded

    card = chip_smoke.card_line()
    print(card, flush=True)
    one_shot = inputs.make_inputs("calgary", 8 << 20, 1, 1)[0]
    archive = inputs.make_inputs("calgary", 16 << 20, 1, 1)[0]
    paths = {"gz6-8m": lambda: gz.compress(one_shot, 6),
             "archive6-16m-write": lambda: sharded.sharded_gzip_compress(archive, 6)}
    out = {"card": card, "runs": runs}
    for name, fn in paths.items():
        fn()  # warm: builds, captures
        torch.cuda.synchronize()
        calls, counts = _record(de, fn)
        torch.cuda.synchronize()
        mb = sum(float(sum(int(v) for v in args[2][:len(args[0])])) for args, _ in calls) / 1e6
        times = {"native": [], "plain": []}
        for r in range(runs):
            order = ("native", "plain") if r % 2 == 0 else ("plain", "native")
            for which in order:
                plan = de.plan_blocks if which == "native" else de._plan_blocks_plain
                t0 = time.perf_counter()
                results = [plan(*args, **kw) for args, kw in calls]
                times[which].append(time.perf_counter() - t0)
                if r == 0:
                    if which == "native":
                        native_results = results
                    else:
                        plain_results = results
        equal = all(_same(a, b) for a, b in zip(native_results, plain_results))
        row = {"batches": len(calls), "rows": sum(len(a[0]) for a, _ in calls), "MB": mb,
               "counts": counts, "equal": equal}
        for which, ts in times.items():
            med = statistics.median(ts)
            row[f"{which}_ms_per_batch"] = 1e3 * med / len(calls)
            row[f"{which}_ms_per_MB"] = 1e3 * med / mb
            row[f"{which}_ms_per_batch_quartiles"] = [
                1e3 * q / len(calls) for q in statistics.quantiles(ts, n=4)]
        out[name] = row
        print(name, json.dumps(row), flush=True)
    print(json.dumps(out))
    return 0 if all(out[n]["equal"] for n in paths) else 1


if __name__ == "__main__":
    sys.exit(main())
