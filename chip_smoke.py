#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (decompress_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each raising at its first failure:
  1. the card: CUDA must be present; prints its name and power limit;
  2. the build: compiles the CUDA kernels from csrc/ (timed);
  3. each kernel against its plain PyTorch version on the card, at the
     production shapes (B=8 segments of 130,560 bytes, P=2^17): mark path,
     histograms and slot build on a real level-4 analysis of the corpus
     batch, literal bits and gains on a real level-6 round A of it (with
     and without a hot-stride lane), plus edge cases (all literals, all
     258-byte jumps or matches running into the row end, a B=1 tail
     batch); exact equality required (integer pipeline), both times
     printed;
  4. the main paths: gz.compress of the 8 MiB corpus (the tests/corpus
     files, sorted, concatenated, repeated, cut) on "cuda" at level 4, then
     at the default level 6 (round B), each checked against the
     reference's size and sha256 and by gzip.decompress; every kernel of
     each path must be launched in that path's run;
  5. where the time goes: stage walls of three warm level-6 runs (host
     clock, a synchronize around each stage) and one profiled run (device
     busy share, device time by kernel, the port's kernels' share).
The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launches on the level-6 path, errors and times.
Exits nonzero, with no result, where CUDA is absent.
"""

from __future__ import annotations

import gzip
import hashlib
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SIZE = 8 << 20
#: gzip of the 8 MiB corpus by the reference JAX package, per level
#: (None = the default level, 6): (bytes, sha256)
EXPECT = {
    4: (2919945, "d95fcf87e22abf3770fa4053470df0cccb4a0db864e7637d3597e72dd8169d09"),
    None: (2854697, "eafff4741db8b10690dc785fcd9e4cbcf5d6dc0eb07cba3c199fe36e754842f4"),
}
#: hot-stride distances for the gain checks' hot lane
HOT = (8, 16, 32, 64, 128, 216, 512, 1024)
TIMING_ITERS = 20
#: the CUDA kernels of csrc/ (device-side names in a profile)
PORT_KERNELS = ("chunk_exit_kernel", "chunk_hop_kernel", "chunk_refine_kernel",
                "hist_kernel", "litbits_kernel", "gain_kernel", "slots_kernel")
#: (C-source, TPU kernel it replaces) per kernel wrapper
SOURCES = {"mark_path": ("mark_path.cu", "decompress_tpu/ops/parse_pl.py:105"),
           "histograms": ("hist.cu", "decompress_tpu/ops/hist_pl.py:90"),
           "litbits": ("cost.cu", "decompress_tpu/ops/cost_pl.py:246"),
           "gain": ("cost.cu", "decompress_tpu/ops/cost_pl.py:294"),
           "build_slots": ("pack_slots.cu", "decompress_tpu/ops/pack_pl.py:92")}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def corpus_bytes() -> bytes:
    corpus = ROOT / "tests" / "corpus"
    base = b"".join(p.read_bytes() for p in sorted(corpus.iterdir()))
    return (base * -(-SIZE // len(base)))[:SIZE]


def time_ms(torch, fn, iters: int = TIMING_ITERS) -> float:
    """Mean device time of fn() in ms over iters launches (CUDA events)."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def max_abs_err(torch, got, want) -> int:
    """Largest elementwise |got - want| over matching tensor tuples."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def masked_slots(torch, slots):
    """Slots with the don't-care value bits (above n) cleared."""
    v01, n01, v23, n23 = slots
    one = torch.ones_like(n01)
    return (v01 & ((one << n01) - 1), n01, v23 & ((one << n23) - 1), n23)


def corpus_batch(torch, de, dev, arr):
    """The first MAX_DEVICE_BATCH segments of the corpus, assembled on
    the card -> (d_data, n_valid numpy, nv, hl, b)."""
    payload, head, n_valid, hist_len, b = de._build_batch_payload(
        arr, 0, de.MAX_DEVICE_BATCH, de.SEGMENT_SIZE)
    d_data = de._assemble_batch_device(torch.from_numpy(payload).to(dev),
                                       torch.from_numpy(head).to(dev))
    return (d_data, n_valid, torch.from_numpy(n_valid).to(dev),
            torch.from_numpy(hist_len).to(dev), b)


def kernel_checks(torch, dev, arr, card) -> dict:
    """Phase 3: every kernel == its plain version at the production
    shapes; returns name -> {max_abs_err, ms, plain_ms}."""
    from decompress_tpu_torch import de
    from decompress_tpu_torch.ops import cost_cu, hist_cu, lz77, pack_cu, parse_cu

    seg = de.SEGMENT_SIZE
    d_data, n_valid, nv, hl, b = corpus_batch(torch, de, dev, arr)
    lit = d_data[:, lz77.HIST:]

    # level 4: mark path, histograms, slot build
    res = lz77.lz77_analyze(d_data, nv, hl, level=4, seg_len=seg)
    take, ln = lz77._take_defer(res["cand_length"], nv, seg, lz77.LEVELS[4].lazy)
    p = lz77._ceil_pow2(seg)
    g2 = lz77.jump_array(take, ln, seg, p)
    idx = torch.arange(p, device=dev, dtype=torch.int32)
    hist_args = (res["on_path"], res["is_match"], res["length"], res["dist"], lit)
    (hv, hb), tabs, _ = de.plan_blocks(
        res["hist_lit"].cpu().numpy(), res["hist_dist"].cpu().numpy(),
        n_valid, [False] * b)
    lit_codes, lit_bits, dist_codes, dist_bits = tabs[:4]
    lit_cb = torch.from_numpy((lit_codes.astype("i4") << 4) | lit_bits).to(dev)
    dist_cb = torch.from_numpy((dist_codes.astype("i4") << 4) | dist_bits).to(dev)
    slot_args = hist_args + (lit_cb, dist_cb)

    # level 6: round A, its cost tables, and round B's inputs as
    # lz77_parse_cost builds them
    res6 = lz77.lz77_analyze(d_data, nv, hl, level=6, seg_len=seg)
    lc, dc = (torch.from_numpy(a.astype("i4")).to(dev) for a in lz77._cost_tables_host(
        res6["hist_lit"].cpu().numpy(), res6["hist_dist"].cpu().numpy()))
    pay = torch.arange(seg, device=dev)
    length = torch.where(pay < nv[:, None], res6["cand_length"], 0)
    dist = res6["cand_dist"]
    lb = cost_cu.litbits_plain(lit, lc)
    pref = torch.cat([torch.zeros_like(lb[:, :1]), torch.cumsum(lb, 1, dtype=torch.int32)], 1)
    hot = torch.tensor([HOT] * b, dtype=torch.int32, device=dev)
    hot_len, hot_d = lz77._hot_lane(d_data, nv, hl, hot, seg_len=seg, hist=lz77.HIST,
                                    max_dist=1 << 15)
    gain_args = (length, dist, None, None, pref, lc, dc)
    gain_hot = (length, dist, hot_len, hot_d, pref, lc, dc)
    print(f"inputs: B={b} seg_len={seg} P={p}; level 4 on-path "
          f"{int(res['on_path'].sum())} matches {int(res['is_match'].sum())}; "
          f"level 6 candidates {int((length >= 3).sum())}, hot-lane runs "
          f"{int((hot_len >= 3).sum())}", flush=True)

    def tail(args):  # the B=1 tail batch
        return tuple(None if a is None else a[:1] for a in args)

    def with_length(args, fill):
        return (torch.full_like(length, fill),) + args[1:]

    checks = {
        "mark_path": (
            parse_cu.mark_path, parse_cu.mark_path_plain,
            [(g2,),
             (torch.clamp(idx + 1, max=p).expand(b, p).contiguous(),),
             (torch.clamp(idx + 258, max=p).expand(b, p).contiguous(),),
             (g2[:1].contiguous(),)],
            lambda o: (o,)),
        "histograms": (
            hist_cu.histograms, hist_cu.histograms_plain,
            [hist_args, tail(hist_args)], lambda o: o),
        "litbits": (
            cost_cu.litbits, cost_cu.litbits_plain,
            [(lit, lc), (lit[:1], lc[:1])], lambda o: (o,)),
        "gain": (
            cost_cu.gain, cost_cu.gain_plain,
            [gain_args, gain_hot, tail(gain_hot), with_length(gain_args, 0),
             with_length(gain_hot, 258)],
            lambda o: o),
        "build_slots": (
            pack_cu.build_slots, pack_cu.build_slots_plain,
            [slot_args, tail(slot_args)], lambda o: masked_slots(torch, o)),
    }
    stats = {}
    for name, (kernel, plain, cases, norm) in checks.items():
        err = 0
        for args in cases:
            got = norm(kernel(*args))
            torch.cuda.synchronize()
            err = max(err, max_abs_err(torch, got, norm(plain(*args))))
        if err:
            raise AssertionError(f"{name}: kernel differs from plain, "
                                 f"max |err| = {err}")
        main_args = cases[0]
        ms = time_ms(torch, lambda: kernel(*main_args))
        plain_ms = time_ms(torch, lambda: plain(*main_args))
        stats[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        print(f"{name}: equal to plain on {len(cases)} cases; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms [{card}]", flush=True)
    return stats


def main_path(torch, data: bytes, level, wrappers, card) -> dict:
    """Phase 4 for one level (None = the default): a warm-up run, then a
    run with every launch count set to 0 just before it; checks the
    bytes and returns the counts."""
    from decompress_tpu_torch import gz

    def run():
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = gz.compress(data, device="cuda") if level is None else \
            gz.compress(data, level=level, device="cuda")
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    out, cold_s = run()
    for fn in wrappers.values():
        fn.launches = 0
    out, warm_s = run()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    sha = hashlib.sha256(out).hexdigest()
    name = "default level (6)" if level is None else f"level {level}"
    print(f"main path: gz.compress {name} of {len(data)} bytes -> {len(out)} "
          f"bytes sha256 {sha}; launches {launches}", flush=True)
    if gzip.decompress(out) != data:
        raise AssertionError("gzip.decompress does not restore the input")
    if (len(out), sha) != EXPECT[level]:
        raise AssertionError(f"output differs from the reference: {len(out)} "
                             f"bytes, sha256 {sha}")
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"{name} path did not launch {missing}")
    print(f"main path wall, {name}: cold {cold_s:.4f} s, warm {warm_s:.4f} s = "
          f"{len(data) / warm_s / 1e6:.2f} MB/s [{card}]", flush=True)
    return launches


def stage_split(torch, data: bytes, card, runs: int = 3) -> None:
    """Per-stage walls of warm level-6 runs (host clock, a synchronize
    around each stage; the analyze2_finish stage holds the host tables,
    the mining and round B), then one profiled run (device busy share,
    device time by kernel)."""
    from decompress_tpu_torch import de, gz
    from decompress_tpu_torch.ops import lz77

    stages = {"round A (lz77_analyze)": (lz77, "lz77_analyze"),
              "round-B host cost tables": (lz77, "_cost_tables_host"),
              "round-B host mining": (lz77, "_hot_dists_host"),
              "round B (lz77_parse_cost)": (lz77, "lz77_parse_cost"),
              "repair + round B (analyze2_finish)": (lz77, "analyze2_finish"),
              "plan_blocks (host)": (de, "plan_blocks"),
              "pack (pack_segments)": (de, "pack_segments")}
    spent = dict.fromkeys(stages, 0.0)
    calls = dict.fromkeys(stages, 0)

    def timed(label, fn):
        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent[label] += time.perf_counter() - t
            calls[label] += 1
            return out
        return wrapper

    originals = {label: getattr(mod, attr) for label, (mod, attr) in stages.items()}
    for label, (mod, attr) in stages.items():
        setattr(mod, attr, timed(label, originals[label]))
    try:
        for r in range(runs):
            for label in stages:
                spent[label], calls[label] = 0.0, 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            gz.compress(data, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            parts = ", ".join(f"{label} {1e3 * s:.1f} ms/{calls[label]}"
                              for label, s in spent.items())
            print(f"stages run {r + 1}: wall {1e3 * wall:.1f} ms; {parts} [{card}]",
                  flush=True)
    finally:
        for label, (mod, attr) in stages.items():
            setattr(mod, attr, originals[label])

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        gz.compress(data, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    span_us = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels)) if kernels else 0
    print(f"profile: wall {1e3 * wall:.1f} ms, {len(kernels)} device kernels, busy "
          f"{busy_us / 1e3:.1f} ms over a {span_us / 1e3:.1f} ms span "
          f"({100 * busy_us / max(span_us, 1):.1f}% busy) [{card}]", flush=True)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    ours = [kv for kv in top if any(f"::{k}(" in kv[0] for k in PORT_KERNELS)]
    print(f"profile: the port's kernels {sum(us for _, us in ours) / 1e3:.3f} ms "
          f"of device time", flush=True)
    for kname, us in top[:20] + ours:
        print(f"  device {us / 1e3:8.3f} ms  {kname[:110]}")


def main() -> int:
    import torch

    # ---- 1. the card ----
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from decompress_tpu_torch import _build, de
    from decompress_tpu_torch.ops import cost_cu, hist_cu, pack_cu, parse_cu

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}",
          flush=True)
    dev = torch.device("cuda")

    # ---- 2. the build ----
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.3f} s -> {lib_path}", flush=True)

    data = corpus_bytes()

    # ---- 3. kernels against their plain versions, production shapes ----
    stats = kernel_checks(torch, dev, de._np_u8(data), card)

    # ---- 4. the main paths: level 4, then the default level 6 ----
    wrappers = {"mark_path": parse_cu.mark_path, "histograms": hist_cu.histograms,
                "build_slots": pack_cu.build_slots}
    main_path(torch, data, 4, wrappers, card)
    wrappers = {"mark_path": parse_cu.mark_path, "histograms": hist_cu.histograms,
                "litbits": cost_cu.litbits, "gain": cost_cu.gain,
                "build_slots": pack_cu.build_slots}
    launches = main_path(torch, data, None, wrappers, card)

    # ---- 5. where the time goes ----
    stage_split(torch, data, card)

    kernels = [
        dict(name=name, route="cuda",
             source=f"decompress_tpu_torch/csrc/{src}", replaces=rep,
             launches=launches[name], **stats[name])
        for name, (src, rep) in SOURCES.items()]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
