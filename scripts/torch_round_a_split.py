#!/usr/bin/env python3
"""Round A's walls, device kernels and device busy share, and the walls of
the paths that pay round A again, for one checkout of
``decompress_tpu_torch``, on one card.

    python3 scripts/torch_round_a_split.py [ROOT] [RUNS]

ROOT (default: the checkout holding this script) is the directory whose
``decompress_tpu_torch`` package is imported and built, so an unpacked
older commit can be compared with this one on one card within one call
(in turns: old, new, new, old, one process each).  On ``chip_smoke.py``'s
8 MiB corpus, after one cold run of each, RUNS (default 5) warm runs,
each a host clock around the call with the card synchronized on both
sides:

* round A (``lz77.lz77_analyze``) of the production batch (the corpus's
  first 8 segments of 130,560 bytes behind their history, T = 163,328)
  at levels 4, 6 and 12, and the host's enqueue time of it (the call
  returns before the card finishes: round A makes no host sync); then a
  profile of one call at each level: its device kernels, the device's
  busy share (kernel time over the span from the first kernel's start
  to the last one's end) and the device time by kernel name (the top 8);
* the level-6 ``gz.compress``: its wall, then its wall with every
  ``lz77_analyze`` call timed (a synchronize on both sides) and round
  A's stage wall; then a profile of one call (device kernels, busy
  share);
* ``gz.Def(6)`` of the first 1 MiB (one device analysis a segment): the
  wall and round A's stage wall;
* ``lzo.compress`` of the corpus at level 6: the wall and its device
  analysis (``lzo._analyze``);
* the fixed step (``ops.pipeline.fixed_deflate_segments``, B = 8, T =
  2^17 of the first 1 MiB, exact extension): the wall, then a profile.

Each output is checked against ``chip_smoke.py``'s reference digest or
totals.  Prints the card's name and power limit and one JSON line last.
Exits 2 without CUDA.
"""

from __future__ import annotations

import gzip
import hashlib
import json
import pathlib
import statistics
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent.parent
LEVELS = (4, 6, 12)


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_round_a_split: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    root = pathlib.Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
    runs = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    sys.path.insert(0, str(HERE))
    import chip_smoke  # the corpus, the digests and the card line
    sys.path.insert(0, str(root))
    from decompress_tpu_torch import _build, de, gz, lzo
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
        top = list(k.pop("by_name_ms").items())[:8]
        return {**k, "top_ms": {name[:90]: ms for name, ms in top}}

    def check(label, out, want):
        got = (len(out), hashlib.sha256(out).hexdigest())
        if got != want:
            raise AssertionError(f"{label}: {got} differs from the reference's {want}")

    analyze = lz77.lz77_analyze
    stage = [0.0]

    def timed_analyze(*args, **kw):
        out, dt = wall(lambda: analyze(*args, **kw))
        stage[0] += dt
        return out

    def staged(fn):
        """fn() with round A timed: (output, wall s, round A s)."""
        stage[0] = 0.0
        lz77.lz77_analyze = timed_analyze
        try:
            out, w = wall(fn)
        finally:
            lz77.lz77_analyze = analyze
        return out, w, stage[0]

    arr = de._np_u8(data)
    seg = de.SEGMENT_SIZE
    staged = de.Batch(de.batch_rows(*de._segments(arr, 0, 8, seg), seg), dev)
    batch = [staged.data, staged.n_valid, staged.hist_len]
    head = data[:1 << 20]
    fixed = np.zeros((chip_smoke.FIXED_B, lz77.HIST + chip_smoke.FIXED_SEG), np.uint8)
    fixed[:, lz77.HIST:] = arr[:chip_smoke.FIXED_B * chip_smoke.FIXED_SEG].reshape(
        chip_smoke.FIXED_B, chip_smoke.FIXED_SEG)
    fb = chip_smoke.FIXED_B
    fixed_args = [torch.from_numpy(a).to(dev) for a in (
        fixed, np.full(fb, chip_smoke.FIXED_SEG, np.int32), np.zeros(fb, np.int32),
        np.ones(fb, np.int32))]

    def streamed():
        enc = gz.Def(6)
        return enc.push(head) + enc.finish()

    def fixed_step():
        words, bits = pipeline.fixed_deflate_segments(*fixed_args, level=6,
                                                      seg_len=chip_smoke.FIXED_SEG)
        if bits.tolist() != list(chip_smoke.FIXED_TOTALS):
            raise AssertionError("fixed step totals differ from the reference")
        return words

    def lzo_run():
        an = lzo._analyze
        spent = [0.0]

        def timed(*args, **kw):
            out, dt = wall(lambda: an(*args, **kw))
            spent[0] += dt
            return out

        lzo._analyze = timed
        try:
            out, w = wall(lambda: lzo.compress(data, level=6, device="cuda"))
        finally:
            lzo._analyze = an
        check("lzo.compress", out, chip_smoke.LZO_EXPECT)
        return w, spent[0]

    def round_a(level):
        return lambda: analyze(*batch, level=level, seg_len=seg)

    def enqueue(fn):
        """Host seconds until fn() returns, the card idle before it."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        dt = time.perf_counter() - t
        torch.cuda.synchronize()
        return dt

    series: dict = {f"round A level {lv}": [] for lv in LEVELS}
    series.update({f"round A level {lv} enqueue": [] for lv in LEVELS})
    series.update({k: [] for k in ("gz.compress", "gz.compress timed", "gz.compress round A",
                                   "gz.Def 1 MiB",
                                   "gz.Def 1 MiB round A", "lzo.compress",
                                   "lzo.compress analysis", "fixed step")})
    for r in range(runs + 1):  # run 0 is the cold one, not kept
        keep = r > 0
        for lv in LEVELS:
            _, w = wall(round_a(lv))
            e = enqueue(round_a(lv))
            if keep:
                series[f"round A level {lv}"].append(w)
                series[f"round A level {lv} enqueue"].append(e)
        out, w = wall(lambda: gz.compress(data, device="cuda"))
        check("gz.compress", out, chip_smoke.EXPECT[None])
        if keep:
            series["gz.compress"].append(w)
        out, w, ra = staged(lambda: gz.compress(data, device="cuda"))
        check("gz.compress", out, chip_smoke.EXPECT[None])
        if keep:
            series["gz.compress timed"].append(w)
            series["gz.compress round A"].append(ra)
        out, w, ra = staged(streamed)
        if gzip.decompress(out) != head:
            raise AssertionError("gz.Def does not restore the first 1 MiB")
        if keep:
            series["gz.Def 1 MiB"].append(w)
            series["gz.Def 1 MiB round A"].append(ra)
        w, an = lzo_run()
        if keep:
            series["lzo.compress"].append(w)
            series["lzo.compress analysis"].append(an)
        _, w = wall(fixed_step)
        if keep:
            series["fixed step"].append(w)

    profiles = {f"round A level {lv}": profiled(round_a(lv)) for lv in LEVELS}
    profiles["gz.compress"] = profiled(lambda: gz.compress(data, device="cuda"))
    profiles["fixed step"] = profiled(fixed_step)

    result = {"root": str(root), "card": card, "runs": runs,
              "warm_s": {k: {"median": statistics.median(v), "min": min(v), "max": max(v),
                             "runs": v} for k, v in series.items()},
              "profiles": profiles}
    for k, v in result["warm_s"].items():
        print(f"{root.name}: {k} warm median {1e3 * v['median']:.1f} ms (min "
              f"{1e3 * v['min']:.1f}, max {1e3 * v['max']:.1f}, {runs} runs) [{card}]",
              flush=True)
    for k, v in profiles.items():
        print(f"{root.name}: {k} profile: {v['device_kernels']} device kernels, busy "
              f"{v['busy_ms']:.1f} ms over {v['span_ms']:.1f} ms "
              f"({100 * v['busy_share']:.1f}% busy) [{card}]", flush=True)
        print(f"{root.name}: {k} device ms by kernel: " + "; ".join(
            f"{name} {ms:.3f}" for name, ms in v["top_ms"].items()), flush=True)
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
