#!/usr/bin/env python3
"""Warm walls of the port's one-shot and sharded level-6 paths, and the
host-blocking CUDA calls of one one-shot call, for one checkout of
``decompress_tpu_torch``, on one card.

    python3 scripts/torch_schedule_walls.py [ROOT] [RUNS]

ROOT (default: the checkout holding this script) is the directory whose
``decompress_tpu_torch`` package is imported and built, so an unpacked
older commit can be compared with this one on one card within one call
(in turns: old, new, new, old, one process each).  On ``chip_smoke.py``'s
8 MiB corpus, after one cold run of each: RUNS (default 5) rounds of
``gz.compress`` (level 6), ``sharded_gzip_compress`` (level 6) and
``sharded_gzip_decompress`` of its archive (``expand="device"`` where the
package takes ``expand``), each a host clock around the call with the
card synchronized on both sides; each output checked against the
reference's digest or the corpus.  Then one profiled ``gz.compress``:
its device busy share and its CUDA runtime calls that hold the host
(``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``, ``cudaMemcpy``) and the host time spent in
them, beside its ``cudaMemcpyAsync`` and ``cudaLaunchKernel`` counts.
Prints the card's name and power limit and one JSON line last.  Exits 2
without CUDA.
"""

from __future__ import annotations

import collections
import hashlib
import inspect
import json
import pathlib
import statistics
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent.parent
BLOCKING_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                  "cudaMemcpy")
RUNTIME_CALLS = BLOCKING_CALLS + ("cudaMemcpyAsync", "cudaLaunchKernel")


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_schedule_walls: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    root = pathlib.Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
    runs = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    sys.path.insert(0, str(HERE))
    import chip_smoke  # the corpus, the digests and the card line
    sys.path.insert(0, str(root))
    from decompress_tpu_torch import gz
    from decompress_tpu_torch.parallel import sharded

    card = chip_smoke.card_line()
    data = chip_smoke.corpus_bytes()
    decode_kw = ({"expand": "device"} if "expand" in inspect.signature(
        sharded.sharded_gzip_decompress).parameters else {})

    def wall(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def check(label, out, want):
        got = (len(out), hashlib.sha256(out).hexdigest())
        if got != want:
            raise AssertionError(f"{label}: {got} differs from the reference's {want}")

    paths = {
        "gz.compress": (lambda: gz.compress(data, device="cuda"),
                        lambda out: check("gz.compress", out, chip_smoke.EXPECT[None])),
        "sharded_gzip_compress": (
            lambda: sharded.sharded_gzip_compress(data, 6, device="cuda"),
            lambda out: check("sharded_gzip_compress", out, chip_smoke.SHARDED_EXPECT)),
    }
    archive, _ = wall(paths["sharded_gzip_compress"][0])

    def decode_check(out):
        if out != data:
            raise AssertionError("sharded_gzip_decompress does not restore the corpus")

    paths["sharded_gzip_decompress"] = (
        lambda: sharded.sharded_gzip_decompress(archive, device="cuda", **decode_kw),
        decode_check)
    walls = {name: [] for name in paths}
    cold = {}
    for name, (fn, ok) in paths.items():
        out, cold[name] = wall(fn)
        ok(out)
    for _ in range(runs):
        for name, (fn, ok) in paths.items():
            out, w = wall(fn)
            ok(out)
            walls[name].append(w)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        paths["gz.compress"][0]()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels)) if kernels else 0
    names = collections.Counter(e.name for e in prof.events())
    calls = {k: names[k] for k in RUNTIME_CALLS}
    blocked = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.name in BLOCKING_CALLS) / 1e3

    result = {"root": str(root), "card": card, "runs": runs, "cold_s": cold,
              "warm_s": {k: {"median": statistics.median(v), "min": min(v), "max": max(v),
                             "runs": v} for k, v in walls.items()},
              "gz_compress_profile": {"busy_ms": busy / 1e3, "span_ms": span / 1e3,
                                      "busy_share": busy / max(span, 1),
                                      "runtime_calls": calls, "host_blocked_ms": blocked}}
    for k, v in result["warm_s"].items():
        print(f"{root.name}: {k} warm median {v['median']:.4f} s (min {v['min']:.4f}, max "
              f"{v['max']:.4f}, {runs} runs), cold {cold[k]:.4f} s [{card}]", flush=True)
    print(f"{root.name}: gz.compress profile: {100 * busy / max(span, 1):.1f}% busy, "
          f"runtime calls {calls}, the host held {blocked:.1f} ms in the blocking ones (the "
          f"harness's synchronize included) [{card}]", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
