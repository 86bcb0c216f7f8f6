"""Run one cell of the benchmark of ``decompress_tpu_torch`` on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names its configuration (``benchmark/configs``) and
traffic mix (``benchmark/traffic``).  The run makes its inputs from the
seed, warms every shape, measures ``--seconds`` of closed-loop calls,
judges the outputs with ``benchmark/reference.py`` and prints one JSON
line: the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
metrics.  It exits nonzero, and prints no result, without a card or
without the program beside it.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402  (the clock above starts first)
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _pin_host(threads: int) -> None:
    """Host thread pools of this process, fixed before numpy and torch load;
    every build and kernel cache inside the checkout, at fixed paths."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "NUMEXPR_NUM_THREADS"):
        os.environ[var] = str(threads)
    cache = ROOT / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    with open(ROOT / "BENCHMARK.json", encoding="utf-8") as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    with open(ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json",
              encoding="utf-8") as f:
        _pin_host(json.load(f)["host_threads"])
    sys.path.insert(0, str(ROOT))

    from benchmark import harness, spec

    return harness.run(spec.load_cell(args.workload, bench), args.seed, args.seconds,
                       bool(args.trace), t_start=_T_START)


if __name__ == "__main__":
    sys.exit(main())
