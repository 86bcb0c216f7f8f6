#!/usr/bin/env python3
"""The archive written by four processes, one card each, checked byte for
byte and split by the exchange's parts.

    python3 scripts/torch_multihost_split.py [--seeds S,...] [--calls N] [--out DIR]

Four processes (``spawn``) meet over gloo on ``127.0.0.1``, each on its
own card, and run ``multihost.sharded_gzip_compress_multihost`` on the
benchmark's inputs (``benchmark/inputs.py``: the Calgary corpus cut to
64 MiB, two inputs a seed; 130,560-byte members, level 6).

* For every seed and input, outside any timing: the archive every
  process holds against the one ``sharded_gzip_compress`` writes on one
  card (process 0's), byte for byte.
* Then N calls (default 6) with the program's tracing on in every
  process, and process 0 inside ``profiling.device_trace``: each
  process's wall time a call in the self intervals of each span
  (``processes.wait``, ``processes.gather``, ``processes.index``, the
  writer's spans) and ``multihost.COUNTS`` a call; process 0's idle
  time on its card by span.

Prints the cards' name and power limit, and one JSON line last (also
written to ``DIR/multihost_split.json``).  Exits 2 without four cards.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
SIZE = 1 << 26
MEMBER = 130_560
WORLD = 4


def _by_span(records, idle=None) -> dict:
    from benchmark import program_spans

    return {n: {k: t[k] for k in ("n", "wall_ns", "idle_ns")}
            for n, t in program_spans.self_times(records, idle).items()}


def _rank(rank: int, port: int, seeds: list, calls: int, out: str) -> None:
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    from benchmark import inputs, program_spans, trace
    from decompress_tpu_torch.parallel import multihost, sharded
    from decompress_tpu_torch.utils import profiling

    torch.set_num_threads(1)
    dev = f"cuda:{rank}"
    torch.cuda.set_device(dev)
    multihost.initialize(f"tcp://127.0.0.1:{port}", WORLD, rank)

    def write(x):
        return multihost.sharded_gzip_compress_multihost(x, 6, member_size=MEMBER, device=dev)

    res: dict = {"rank": rank, "checks": []}
    data = []
    for seed in seeds:
        data = inputs.make_inputs("calgary", SIZE, seed, 2)
        for k, x in enumerate(data):
            arch = write(x)
            digests = [None] * WORLD
            dist.all_gather_object(digests, hashlib.sha256(arch).hexdigest())
            if rank == 0:
                single = sharded.sharded_gzip_compress(x, 6, member_size=MEMBER, device=dev)
                res["checks"].append({"seed": seed, "input": k, "bytes": len(arch),
                                      "same_across_processes": len(set(digests)) == 1,
                                      "equal_to_one_card": arch == single})
    for x in data:  # warm
        write(x)
    torch.cuda.synchronize()
    walls, counts = [], []
    with profiling.tracing() as records:
        ctx = profiling.device_trace(ROOT / "build" / "trace_multihost") if rank == 0 else None
        prof = ctx.__enter__() if ctx is not None else None
        dist.barrier()  # every process starts the first call with its profiler up
        t0_ns = time.time_ns()
        for j in range(calls):
            before = dict(multihost.COUNTS)
            t = time.perf_counter()
            write(data[j % len(data)])
            walls.append(1e3 * (time.perf_counter() - t))
            counts.append({k: v - before.get(k, 0) for k, v in multihost.COUNTS.items()})
        torch.cuda.synchronize()
        t1_ns = time.time_ns()
        if ctx is not None:
            ctx.__exit__(None, None, None)
    res.update(call_ms=walls, counts=counts, spans=_by_span(records))
    if prof is not None:
        activity = trace.device_activity(trace.device_events(prof), t0_ns, t1_ns)
        res["device"] = {"busy_s": activity["busy_s"], "window_s": activity["window_s"]}
        idle = program_spans._Idle(activity["gaps"])
        res["idle_by_span"] = _by_span(records, idle)
        res["device"]["idle_s"] = int(idle.before[-1]) / 1e9
    with open(pathlib.Path(out) / f"rank{rank}.json", "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="2000000041,2000000042")
    ap.add_argument("--calls", type=int, default=6)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "multihost"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        print(f"needs {WORLD} cards", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout,
          flush=True)
    from benchmark import ranks
    from decompress_tpu_torch import _build, native

    _build.build()
    native.build()
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    port = ranks.free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, port, seeds, args.calls, str(out)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(1800)
    codes = [p.exitcode for p in procs]
    if codes != [0] * WORLD:
        for p in procs:
            if p.is_alive():
                p.terminate()
        print(f"process exit codes {codes}", file=sys.stderr)
        return 1
    reports = [json.loads((out / f"rank{r}.json").read_text()) for r in range(WORLD)]
    summary = {"checks": reports[0]["checks"], "ranks": []}
    for r in reports:
        n = len(r["call_ms"])
        summary["ranks"].append({
            "rank": r["rank"], "call_ms": r["call_ms"], "counts_a_call": r["counts"][-1],
            "self_ms_a_call": {k: v["wall_ns"] / 1e6 / n for k, v in sorted(r["spans"].items())}})
    r0 = reports[0]
    summary["device0"] = r0["device"]
    summary["idle_s_by_span0"] = {k: v["idle_ns"] / 1e9
                                  for k, v in sorted(r0["idle_by_span"].items())}
    summary["MBps_traced"] = (SIZE / 1e6 * len(r0["call_ms"])) / (sum(r0["call_ms"]) / 1e3)
    line = json.dumps(summary)
    (out / "multihost_split.json").write_text(line + "\n")
    ok = all(c["same_across_processes"] and c["equal_to_one_card"] for c in summary["checks"])
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
