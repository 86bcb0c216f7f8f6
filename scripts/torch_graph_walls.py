#!/usr/bin/env python3
"""Stage walls, host enqueue, device kernels and busy share of the
compression paths for one checkout of ``decompress_tpu_torch``, or for
two checkouts interleaved, on one card.

    python3 scripts/torch_graph_walls.py [ROOT] [RUNS]
    python3 scripts/torch_graph_walls.py --compare PARENT [RUNS]

ROOT (default: the checkout holding this script) is the directory whose
``decompress_tpu_torch`` package is imported and built.  ``--compare``
runs PARENT and this checkout in turns, one process each (parent,
change, change, parent), and prints the medians of both sides' runs
beside each other.  On ``chip_smoke.py``'s 8 MiB corpus, after one cold
run of each, RUNS (default 5) warm runs, each a host clock around the
call with the card synchronized on both sides:

* round A (``lz77.lz77_analyze``) of the production batch (B = 8, T =
  163,328, level 6): its wall and the host's enqueue of it (the call
  returns before the card finishes);
* the level-6 ``gz.compress``: its wall, then its wall with round A,
  round B (``lz77.lz77_parse_cost``), ``plan_blocks`` and the pack
  (``de.pack_segments``) each timed with a synchronize on both sides:
  the stage walls;
* ``gz.Def(6)`` of the first 1 MiB (one device analysis a segment): the
  wall and round A's stage wall;
* the fixed step (``ops.pipeline.fixed_deflate_segments``, B = 8, T =
  2^17 of the first 1 MiB);
* the command line's cold wall: ``python -m decompress_tpu_torch.cli -f
  gzip -l 6`` of the corpus in a new process (imports, the kernel
  library's load and every capture included), once a run.

Then one profile each of round A, the level-6 ``gz.compress``, the
streamed 1 MiB and the fixed step: device kernels, busy ms over the span
from the first kernel's start to the last one's end, busy share.  Each
output is checked against ``chip_smoke.py``'s reference digests.  Prints
the card's name and power limit and one JSON line last.  Exits 2 without
CUDA.
"""

from __future__ import annotations

import gzip
import hashlib
import json
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent.parent
CLI_TIMEOUT = 300


def measure(root: pathlib.Path, runs: int) -> dict:
    """The series and profiles of one checkout, in this process."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(HERE))
    import chip_smoke  # the corpus, the digests and the card line
    sys.path.insert(0, str(root))
    from decompress_tpu_torch import _build, de, gz
    from decompress_tpu_torch.ops import lz77, pipeline

    card = chip_smoke.card_line()
    data = chip_smoke.corpus_bytes()
    dev = torch.device("cuda")
    _build.build()

    def wall(fn):
        return chip_smoke.timed_call(torch, fn)

    def profiled(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        k = chip_smoke.kernel_summary(torch, prof)
        k.pop("by_name_ms")
        return k

    def check(label, out, want):
        got = (len(out), hashlib.sha256(out).hexdigest())
        if got != want:
            raise AssertionError(f"{label}: {got} differs from the reference's {want}")

    stages = {"round A": (lz77, "lz77_analyze"), "round B": (lz77, "lz77_parse_cost"),
              "plan_blocks": (de, "plan_blocks"), "pack": (de, "pack_segments")}
    spent = dict.fromkeys(stages, 0.0)

    def timer(label, fn):
        def call(*args, **kw):
            out, dt = wall(lambda: fn(*args, **kw))
            spent[label] += dt
            return out
        return call

    def staged(fn):
        """fn() with every stage timed: (output, wall s, {stage: s})."""
        originals = {label: getattr(mod, name) for label, (mod, name) in stages.items()}
        for label in stages:
            spent[label] = 0.0
        try:
            for label, (mod, name) in stages.items():
                setattr(mod, name, timer(label, originals[label]))
            out, w = wall(fn)
        finally:
            for label, (mod, name) in stages.items():
                setattr(mod, name, originals[label])
        return out, w, dict(spent)

    arr = de._np_u8(data)
    seg = de.SEGMENT_SIZE
    staged = de.Batch(de.batch_rows(*de._segments(arr, 0, 8, seg), seg), dev)
    batch = [staged.data, staged.n_valid, staged.hist_len]
    head = data[:1 << 20]
    fb, fseg = chip_smoke.FIXED_B, chip_smoke.FIXED_SEG
    fixed = np.zeros((fb, lz77.HIST + fseg), np.uint8)
    fixed[:, lz77.HIST:] = arr[:fb * fseg].reshape(fb, fseg)
    fixed_args = [torch.from_numpy(a).to(dev) for a in (
        fixed, np.full(fb, fseg, np.int32), np.zeros(fb, np.int32), np.ones(fb, np.int32))]

    def round_a():
        return lz77.lz77_analyze(*batch, level=6, seg_len=seg)

    def one_shot():
        return gz.compress(data, device="cuda")

    def streamed():
        enc = gz.Def(6)
        return enc.push(head) + enc.finish()

    def fixed_step():
        words, bits = pipeline.fixed_deflate_segments(*fixed_args, level=6, seg_len=fseg)
        if bits.tolist() != list(chip_smoke.FIXED_TOTALS):
            raise AssertionError("fixed step totals differ from the reference")
        return words

    def cli():
        t = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "decompress_tpu_torch.cli", "-f", "gzip",
                            "-l", "6"], input=data, capture_output=True, cwd=root,
                           timeout=CLI_TIMEOUT, check=False)
        dt = time.perf_counter() - t
        if p.returncode != 0:
            raise AssertionError(f"cli failed: {p.stderr.decode()[-2000:]}")
        check("cli -f gzip -l 6", p.stdout, chip_smoke.EXPECT[None])
        return dt

    series: dict = {}

    def keep(r, name, value):
        if r > 0:  # run 0 is the cold one, not kept
            series.setdefault(name, []).append(value)

    for r in range(runs + 1):
        keep(r, "round A", wall(round_a)[1])
        keep(r, "round A enqueue", chip_smoke.enqueue_s(torch, round_a))
        out, w = wall(one_shot)
        check("gz.compress", out, chip_smoke.EXPECT[None])
        keep(r, "gz.compress", w)
        out, w, st = staged(one_shot)
        check("gz.compress", out, chip_smoke.EXPECT[None])
        keep(r, "gz.compress timed", w)
        for label, s in st.items():
            keep(r, f"gz.compress {label}", s)
        out, w, st = staged(streamed)
        if gzip.decompress(out) != head:
            raise AssertionError("gz.Def does not restore the first 1 MiB")
        keep(r, "gz.Def 1 MiB", w)
        keep(r, "gz.Def 1 MiB round A", st["round A"])
        keep(r, "fixed step", wall(fixed_step)[1])
        if r > 0:
            keep(r, "cli cold", cli())

    profiles = {"round A": profiled(round_a), "gz.compress": profiled(one_shot),
                "gz.Def 1 MiB": profiled(streamed), "fixed step": profiled(fixed_step)}
    return {"root": str(root), "card": card, "runs": runs, "warm_s": series,
            "profiles": profiles}


def _median_ms(v: list) -> str:
    return f"{1e3 * statistics.median(v):.1f} ms"


def compare(parent: pathlib.Path, runs: int) -> int:
    """Parent, change, change, parent, one process each; both sides'
    medians over all their runs, beside each other."""
    sides = {"parent": [], "change": []}
    card = None
    for side, root in (("parent", parent), ("change", HERE), ("change", HERE),
                       ("parent", parent)):
        p = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()), str(root),
                            str(runs)], capture_output=True, text=True, check=False)
        *lines, last = p.stdout.rstrip("\n").split("\n")
        print("\n".join(lines), flush=True)
        if p.returncode != 0:
            sys.stderr.write(last + "\n" + p.stderr[-4000:])
            return p.returncode
        res = json.loads(last)
        card = res["card"]
        sides[side].append(res)
    out = {}
    for name in sides["change"][0]["warm_s"]:
        both = {side: [x for r in rs for x in r["warm_s"][name]] for side, rs in sides.items()}
        out[name] = {side: statistics.median(v) for side, v in both.items()}
        print(f"{name}: parent {_median_ms(both['parent'])}, change "
              f"{_median_ms(both['change'])} (medians of {len(both['change'])} runs each, "
              f"interleaved) [{card}]", flush=True)
    for name in sides["change"][0]["profiles"]:
        for side, rs in sides.items():
            ks = [r["profiles"][name] for r in rs]
            print(f"{name} profile, {side}: device kernels "
                  f"{[k['device_kernels'] for k in ks]}, busy ms "
                  f"{[round(k['busy_ms'], 1) for k in ks]} over spans "
                  f"{[round(k['span_ms'], 1) for k in ks]} ms, busy "
                  f"{[round(100 * k['busy_share'], 1) for k in ks]}% [{card}]", flush=True)
    print(card)
    print(json.dumps({"card": card, "medians_s": out,
                      "profiles": {side: [r["profiles"] for r in rs]
                                   for side, rs in sides.items()}}))
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_graph_walls: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if args and args[0] == "--compare":
        return compare(pathlib.Path(args[1]).resolve(), int(args[2]) if len(args) > 2 else 5)
    root = pathlib.Path(args[0]).resolve() if args else HERE
    res = measure(root, int(args[1]) if len(args) > 1 else 5)
    for name, v in res["warm_s"].items():
        print(f"{root.name}: {name} warm median {_median_ms(v)} (min {1e3 * min(v):.1f}, "
              f"max {1e3 * max(v):.1f}, {len(v)} runs) [{res['card']}]", flush=True)
    for name, k in res["profiles"].items():
        print(f"{root.name}: {name} profile: {k['device_kernels']} device kernels, busy "
              f"{k['busy_ms']:.1f} ms over {k['span_ms']:.1f} ms "
              f"({100 * k['busy_share']:.1f}% busy) [{res['card']}]", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
