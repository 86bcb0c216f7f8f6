#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (decompress_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each raising at its first failure:
  1. the card: CUDA must be present; prints its name and power limit;
  2. the build: compiles the CUDA kernels from csrc/ (timed);
  3. each kernel against its plain PyTorch version on the card, at the
     production shapes (B=8 segments of 130,560 bytes, P=2^17): mark path,
     histograms and slot build on a real level-4 analysis of the corpus
     batch, literal bits with their prefix sum and gains on a real level-6
     round A of it (with and without a hot-stride lane), plus edge cases
     (all literals, all 258-byte jumps or matches running into the row
     end, a B=1 tail batch; for the mark path jumps past its staged head
     table, 1000 long or random up to 4096, P = 2^18 and P = 512; for the
     literal bits T = 1, a ragged T, unaligned rows and 9 rows; for the
     histograms 9 rows, T = 1, T off 16 positions, unaligned payload rows,
     one literal or one match everywhere, nothing on the path); exact
     equality required (integer pipeline), both times printed, the device
     time L2-warm and cold (64 MB overwritten before each launch), and of
     each CUDA kernel of a wrapper that launches several;
  4. the main paths: gz.compress of the 8 MiB corpus (the tests/corpus
     files, sorted, concatenated, repeated, cut) on "cuda" at level 4, then
     at the default level 6 (round B), each checked against the
     reference's size and sha256 and by gzip.decompress; every kernel of
     each path must be launched in that path's run;
  5. where the time goes: stage walls of three warm level-6 runs (host
     clock, a synchronize around each stage) and one profiled run (device
     busy share, device time by kernel, the port's kernels' share);
  6. the sharded round trip: sharded_gzip_compress of the corpus at level 6
     (65 members of 130,560 bytes, splits every 8192 bits) checked against
     the reference's size and sha256 and by gzip.decompress, then
     sharded_gzip_decompress of it on the card, which must return the
     corpus with the decode and CRC kernels launched and no serial
     fallback; cold and warm walls of both halves and the decode's stage
     split;
  7. the decode and CRC kernels against their plain versions on the card:
     the archive's split rows, one member's rows alone, a fixed-Huffman
     member, a member with one flipped bit (both must reject its final
     row), rows starting before and past a body, the archive with 40 bits
     flipped in every member's first row; the synchronisation rounds per
     row of the archive; the CRC chunk registers of the decoded members
     and of rows of lengths 0, 1, 255, 256, 257 and 130,560.
The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launches on the path that uses them (the default
level-6 gz.compress for the compression kernels, the sharded round trip
for decode and CRC), errors, times and bounds; "ms" is a CUDA-event loop
of launches, "device_ms" and "device_cold_ms" the kernels' own device
time from a profile, L2-warm and with the L2 flushed before each launch.
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
#: level-6 sharded archive of the 8 MiB corpus by the reference JAX package
SHARDED_EXPECT = (2920438, "62c7742f29bb8256dd846422c895955fb94149d423b1b6a33f79d12f420941f9")
#: device-memory rate of an H100 SXM (bytes/s), for the kernels' bounds
HBM_BYTES_PER_S = 3.35e12
#: hot-stride distances for the gain checks' hot lane
HOT = (8, 16, 32, 64, 128, 216, 512, 1024)
TIMING_ITERS = 20
#: bytes overwritten between launches for the cold-L2 device times (the
#: H100's L2 holds 50 MB)
FLUSH_BYTES = 64 << 20
#: the CUDA kernels of csrc/ (device-side names in a profile)
PORT_KERNELS = ("chunk_exit_kernel", "chunk_hop_kernel", "chunk_refine_kernel",
                "hist_kernel", "litbits_tally_kernel", "litbits_scan_kernel", "gain_kernel",
                "slots_kernel", "inflate_rows_kernel", "crc_chunks_kernel")
#: (C-source, TPU kernel it replaces) per kernel wrapper
SOURCES = {"mark_path": ("mark_path.cu", "decompress_tpu/ops/parse_pl.py:105"),
           "histograms": ("hist.cu", "decompress_tpu/ops/hist_pl.py:90"),
           "litbits": ("cost.cu", "decompress_tpu/ops/cost_pl.py:246"),
           "gain": ("cost.cu", "decompress_tpu/ops/cost_pl.py:294"),
           "build_slots": ("pack_slots.cu", "decompress_tpu/ops/pack_pl.py:92"),
           "decode": ("inflate.cu", "decompress_tpu/ops/inflate_pl.py:415"),
           "chunk_registers": ("crc.cu", "decompress_tpu/ops/checksum.py:217")}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def corpus_bytes() -> bytes:
    corpus = ROOT / "tests" / "corpus"
    base = b"".join(p.read_bytes() for p in sorted(corpus.iterdir()))
    return (base * -(-SIZE // len(base)))[:SIZE]


def time_ms(torch, fn, iters: int = TIMING_ITERS, warmup: int = 3) -> float:
    """Mean device time of fn() in ms over iters launches (CUDA events)."""
    for _ in range(warmup):
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


def port_kernel(name: str) -> str | None:
    """The PORT_KERNELS entry a profiled device kernel is, if any (a
    templated kernel's name carries its arguments: ``::k<10>(``)."""
    return next((k for k in PORT_KERNELS if f"::{k}(" in name or f"::{k}<" in name), None)


def device_split(torch, fn, iters: int = TIMING_ITERS, flush=None) -> tuple[dict, int]:
    """Device time in ms per call of each of the port's kernels launched
    by fn(), by kernel name, from a profiler trace: the kernels' own
    durations without the host's enqueue time, which bounds a CUDA-event
    loop of small launches; and the device kernels per call, the port's
    or not.  With ``flush``, flush() runs before every call (cold L2; its
    own kernels are not the port's, so they are not in the split)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    return per_call(torch, prof, iters)


def per_call(torch, prof, iters: int) -> tuple[dict, int]:
    """Device ms per call of each of the port's kernels, and device
    kernels per call, from a profile of ``iters`` calls.  The profiler may
    drop a few kernel records of a long run, so each kernel's time per
    call is its mean duration times its launches per call, and those are
    the record count over ``iters``, rounded."""
    durations: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            durations.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    split: dict = {}
    kernels = 0
    for name, d in durations.items():
        launches = max(1, round(len(d) / iters))
        kernels += launches
        k = port_kernel(name)
        if k is not None:
            split[k] = split.get(k, 0.0) + sum(d) / len(d) * launches
    return split, kernels


def tensors(args):
    """The tensors of an argument list, tuples flattened."""
    out = []
    for a in args:
        out.extend(tensors(a) if isinstance(a, (tuple, list)) else
                   [a] if hasattr(a, "nbytes") else [])
    return out


def bound_ms(args, outputs) -> float:
    """Least time the card could take: each input tensor read once and
    each output written once, over the device-memory rate."""
    moved = sum(t.nbytes for t in tensors(args) + tensors(outputs))
    return 1e3 * moved / HBM_BYTES_PER_S


def check_kernel(torch, name, kernel, plain, cases, norm, library=None, *, card,
                 plain_iters=TIMING_ITERS) -> dict:
    """Kernel == plain version (exactly) on every case; times both, and
    the library call where one computes the same function, on cases[0]."""
    err = 0
    for args in cases:
        got = norm(kernel(*args))
        torch.cuda.synchronize()
        err = max(err, max_abs_err(torch, got, norm(plain(*args))))
    if err:
        raise AssertionError(f"{name}: kernel differs from plain, max |err| = {err}")
    main_args = cases[0]
    ms = time_ms(torch, lambda: kernel(*main_args))
    plain_ms = time_ms(torch, lambda: plain(*main_args), plain_iters,
                       min(3, plain_iters))
    library_ms = None if library is None else time_ms(torch, library)
    split, kernels = device_split(torch, lambda: kernel(*main_args))
    scratch = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    cold, _ = device_split(torch, lambda: kernel(*main_args), flush=lambda: scratch.fill_(1))
    stat = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms(main_args, kernel(*main_args)), bound_by="bytes",
                library_ms=library_ms, device_ms=sum(split.values()),
                device_cold_ms=sum(cold.values()), device_kernels_per_call=kernels)
    lib = "" if library_ms is None else f", library call {library_ms:.4f} ms"
    print(f"{name}: equal to plain on {len(cases)} cases; kernel {ms:.4f} ms "
          f"(device {stat['device_ms']:.4f} ms L2-warm, {stat['device_cold_ms']:.4f} ms "
          f"cold; {kernels} device kernels a call), plain {plain_ms:.4f} ms{lib}, "
          f"bound {stat['bound_ms']:.4f} ms [{card}]", flush=True)
    if len(split) > 1:
        stat["device_split"] = split
        stat["device_cold_split"] = cold
        print(f"{name}: device ms by kernel " + ", ".join(
            f"{k} {v:.4f} (cold {cold.get(k, 0.0):.4f})" for k, v in split.items())
            + f" [{card}]", flush=True)
    return stat


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
    from decompress_tpu_torch import _build, de
    from decompress_tpu_torch.ops import cost_cu, hist_cu, lz77, pack_cu, parse_cu

    seg = de.SEGMENT_SIZE
    d_data, n_valid, nv, hl, b = corpus_batch(torch, de, dev, arr)
    lit = d_data[:, lz77.HIST:]

    # level 4: mark path, histograms, slot build
    res = lz77.lz77_analyze(d_data, nv, hl, level=4, seg_len=seg)
    take, ln = lz77._take_defer(res["cand_length"], nv, seg, lz77.LEVELS[4].lazy)
    p = lz77._ceil_pow2(seg)
    g2 = lz77.jump_array(take, ln, seg, p)
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
    _, pref = cost_cu.litbits_pref_plain(lit, lc)
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

    def jumps(steps, p_):  # g of these steps from every position, capped at p_
        return torch.clamp(torch.arange(p_, device=dev, dtype=torch.int32) + steps,
                           max=p_).expand(b, p_).contiguous()

    gen = torch.Generator(device=dev).manual_seed(4096)
    p2 = 2 * p  # more chunks than the hop's shared-memory ring holds
    long_steps = torch.where(torch.rand((b, p2), device=dev, generator=gen) < 0.5,
                             torch.randint(1, 4097, (b, p2), device=dev, generator=gen,
                                           dtype=torch.int32), 1)
    lit_idx = lit.to(torch.int64)
    rng_lit = torch.randint(0, 256, (9, 5000), device=dev, generator=gen, dtype=torch.uint8)
    rng_lc = torch.randint(1, 16, (9, 286), device=dev, generator=gen, dtype=torch.int32)
    unaligned = d_data[:, lz77.HIST + 3:lz77.HIST + 3 + 9000]

    def hist_cut(t, lit_off=0):  # the first t positions; the payload rows shifted
        return tuple(a[:, :t].contiguous() for a in hist_args[:4]) + (
            d_data[:, lz77.HIST + lit_off:lz77.HIST + lit_off + t],)

    def rows9(args):  # 9 segments: the batch and its first row again
        return tuple(torch.cat([a, a[:1]]) for a in args[:4]) + (
            torch.cat([d_data, d_data[:1]])[:, lz77.HIST:],)

    on_all, off_all = torch.ones_like(res["on_path"]), torch.zeros_like(res["on_path"])
    one_literal = (on_all, off_all) + hist_args[2:4] + (
        torch.full_like(d_data, 97)[:, lz77.HIST:],)
    one_match = (on_all, on_all, torch.full_like(res["length"], 258),
                 torch.full_like(res["dist"], 1), lit)
    checks = {
        "mark_path": (
            parse_cu.mark_path, parse_cu.mark_path_plain,
            [(g2,), (jumps(1, p),), (jumps(258, p),), (g2[:1].contiguous(),),
             (jumps(1000, p),), (jumps(long_steps[:, :p], p),), (jumps(long_steps, p2),),
             (jumps(1000, p2),), (g2[:, :512].clamp(max=512).contiguous(),)],
            lambda o: (o,)),
        "histograms": (
            hist_cu.histograms, hist_cu.histograms_plain,
            [hist_args, tail(hist_args), rows9(hist_args), hist_cut(1), hist_cut(4103),
             hist_cut(seg - 16, 3), one_literal, one_match,
             (off_all, off_all) + hist_args[2:]], lambda o: o),
        "litbits": (
            cost_cu.litbits_pref, cost_cu.litbits_pref_plain,
            [(lit, lc), (lit[:1], lc[:1]), (lit[:, :1], lc), (lit[:, :5000], lc),
             (unaligned, lc), (rng_lit, rng_lc)], lambda o: o,
            lambda: torch.gather(lc, 1, lit_idx)),
        "gain": (
            cost_cu.gain, cost_cu.gain_plain,
            [gain_args, gain_hot, tail(gain_hot), with_length(gain_args, 0),
             with_length(gain_hot, 258)],
            lambda o: o),
        "build_slots": (
            pack_cu.build_slots, pack_cu.build_slots_plain,
            [slot_args, tail(slot_args)], lambda o: masked_slots(torch, o)),
    }
    stats = {name: check_kernel(torch, name, *spec, card=card)
             for name, spec in checks.items()}
    if stats["histograms"]["device_kernels_per_call"] != 1:
        raise AssertionError("histograms: a call launched more than its one kernel")
    print(f"histograms: clusters of {_build.lib().dtt_hist_cluster_blocks()} blocks a "
          f"segment", flush=True)

    def replaced():  # what round B ran for the prefix before the fused kernel
        bits = torch.gather(lc, 1, lit_idx)
        return torch.cat([torch.zeros_like(bits[:, :1]),
                          torch.cumsum(bits, 1, dtype=torch.int32)], 1)

    seq_ms = time_ms(torch, replaced)
    stats["litbits"]["torch_sequence_ms"] = seq_ms
    print(f"litbits: the torch sequence it replaces (gather, zeros_like, cumsum, cat) "
          f"{seq_ms:.4f} ms against the kernel's {stats['litbits']['ms']:.4f} ms [{card}]",
          flush=True)
    return stats


def main_path(torch, data: bytes, level, wrappers, card) -> dict:
    """Phase 4 for one level (None = the default): a warm-up run, then a
    run with every launch count set to 0 just before it; checks the
    bytes and returns the counts of the named ``wrappers``."""
    from decompress_tpu_torch import _build, gz

    def run():
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = gz.compress(data, device="cuda") if level is None else \
            gz.compress(data, level=level, device="cuda")
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    out, cold_s = run()
    _build.LAUNCHES.clear()
    out, warm_s = run()
    launches = {name: _build.LAUNCHES[name] for name in wrappers}
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
    ours = [kv for kv in top if port_kernel(kv[0])]
    print(f"profile: the port's kernels {sum(us for _, us in ours) / 1e3:.3f} ms "
          f"of device time", flush=True)
    for kname, us in top[:20] + ours:
        print(f"  device {us / 1e3:8.3f} ms  {kname[:110]}")


def sharded_path(torch, data: bytes, wrappers, card):
    """Phase 6: the sharded round trip, each half run cold, then warm with
    every launch count set to 0 just before it; checks the archive against
    the reference's and the round trip, prints walls and the decode's
    stage split.  Returns (archive, launches of both warm halves)."""
    from decompress_tpu_torch import _build
    from decompress_tpu_torch.ops import checksum, inflate, inflate_cu
    from decompress_tpu_torch.parallel import sharded

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def compress():
        return sharded.sharded_gzip_compress(data, 6, device="cuda")

    archive, cold_c = timed(compress)
    _build.LAUNCHES.clear()
    archive, warm_c = timed(compress)
    launches_c = {name: _build.LAUNCHES[name] for name in wrappers}
    sha = hashlib.sha256(archive).hexdigest()
    print(f"sharded: sharded_gzip_compress level 6 of {len(data)} bytes -> "
          f"{len(archive)} bytes sha256 {sha}; launches {launches_c}", flush=True)
    if (len(archive), sha) != SHARDED_EXPECT:
        raise AssertionError(f"sharded archive differs from the reference: "
                             f"{len(archive)} bytes, sha256 {sha}")
    if gzip.decompress(archive) != data:
        raise AssertionError("gzip.decompress does not restore the sharded archive")

    stages = {"host plan (decode_plan)": (sharded, "decode_plan"),
              "staging and tables (stage)": (inflate_cu, "stage"),
              "decode kernel (decode)": (inflate_cu, "decode"),
              "compaction (slot_counts_bits)": (inflate, "slot_counts_bits"),
              "compaction (compact_commands)": (inflate, "compact_commands"),
              "expansion (expand_commands)": (inflate, "expand_commands"),
              "CRC (crc32_batch_device)": (checksum, "crc32_batch_device")}
    spent = dict.fromkeys(stages, 0.0)
    originals = {label: getattr(mod, attr) for label, (mod, attr) in stages.items()}

    def stage_timer(label, fn):
        def wrapper(*args, **kw):
            out, dt = timed(lambda: fn(*args, **kw))
            spent[label] += dt
            return out
        return wrapper

    def decompress():
        return sharded.sharded_gzip_decompress(archive, device="cuda")

    sharded.serial_fallbacks.clear()
    out, cold_d = timed(decompress)
    _build.LAUNCHES.clear()
    out, warm_d = timed(decompress)
    launches_d = {name: _build.LAUNCHES[name] for name in wrappers}
    print(f"sharded: sharded_gzip_decompress -> {len(out)} bytes; launches "
          f"{launches_d}; serial fallbacks {dict(sharded.serial_fallbacks)}", flush=True)
    if out != data:
        raise AssertionError("sharded_gzip_decompress does not restore the input")
    if sharded.serial_fallbacks:
        raise AssertionError(f"serial route taken: {dict(sharded.serial_fallbacks)}")
    missing = [n for n in ("decode", "chunk_registers") if launches_d[n] <= 0]
    missing += [n for n, c in launches_c.items() if c <= 0 and n != "decode"]
    if missing:
        raise AssertionError(f"sharded round trip did not launch {missing}")
    print(f"sharded wall: compress cold {cold_c:.4f} s, warm {warm_c:.4f} s = "
          f"{len(data) / warm_c / 1e6:.2f} MB/s; decompress cold {cold_d:.4f} s, "
          f"warm {warm_d:.4f} s = {len(data) / warm_d / 1e6:.2f} MB/s [{card}]",
          flush=True)

    for label, (mod, attr) in stages.items():
        setattr(mod, attr, stage_timer(label, originals[label]))
    try:
        for r in range(3):
            for label in stages:
                spent[label] = 0.0
            _, wall = timed(decompress)
            parts = ", ".join(f"{label} {1e3 * t:.1f} ms" for label, t in spent.items())
            print(f"decode stages run {r + 1}: wall {1e3 * wall:.1f} ms; {parts} [{card}]",
                  flush=True)
    finally:
        for label, (mod, attr) in stages.items():
            setattr(mod, attr, originals[label])
    return archive, {n: launches_c[n] + launches_d[n] for n in wrappers}


def decode_crc_checks(torch, dev, data: bytes, archive: bytes, card) -> dict:
    """Phase 7: the decode and CRC kernels == their plain versions."""
    import zlib

    import numpy as np

    from decompress_tpu_torch.ops import checksum, crc_cu, inflate, inflate_cu
    from decompress_tpu_torch.parallel import sharded

    metas, huff, rows, max_cmds = sharded.decode_plan(np.frombuffer(archive, np.uint8))

    def args(st, cap):
        return (st["words"], st["tabs"], st["row_ptr"], st["start"], st["stop"], st["nbits"],
                st["blocks"], cap)

    def staged(members, flip=None):
        bodies = [metas[i][1].copy() for i in members]
        if flip == "eob":  # a bit of the first member's end-of-block code
            bodies[0][-1] ^= 1 << 7 if bodies[0][-1] >> 7 else 1
        elif flip == "interior":  # 40 bits of every member's first row
            rng = np.random.default_rng(11)
            for body, i in zip(bodies, members):
                (s0, s1), = rows[huff.index(i)][:1]
                for bit in rng.integers(s0, s1 or body.size * 8, 40):
                    body[bit >> 3] ^= 1 << (bit & 7)
        st = inflate_cu.stage(bodies, [metas[i][0][1] for i in members],
                              [metas[i][0][2] for i in members],
                              [rows[huff.index(i)] for i in members], dev)
        return args(st, max_cmds)

    fixed_in = data[:20_000]
    c = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)
    body = np.frombuffer(c.compress(fixed_in) + c.flush(), np.uint8)
    _, ll, dl, start = inflate.prepare_member(body)
    fixed = args(inflate_cu.stage([body], [ll], [dl], [[(start, 0)]], dev), len(fixed_in) + 2)
    # rows starting before and far past a body read only clamped words
    clamped = args(inflate_cu.stage([body] * 2, [ll] * 2, [dl] * 2,
                                    [[(-40, 0)], [(body.size * 8 + 4096, 0)]], dev), 64)
    cases = [staged(huff), staged(huff[-1:]), fixed, staged(huff[:1], flip="eob"), clamped,
             staged(huff, flip="interior")]
    print(f"decode inputs: {len(huff)} members, {int(cases[0][2][-1])} rows, "
          f"max_cmds {max_cmds}; fixed member of {len(fixed_in)} bytes", flush=True)
    if not all(bool(inflate_cu.decode(*a)[1].all()) for a in cases[:3]):
        raise AssertionError("decode: a valid row was rejected")
    bad_ok = inflate_cu.decode(*cases[3])[1]
    if (~bad_ok).nonzero().flatten().tolist() != [len(rows[0]) - 1]:
        raise AssertionError(f"decode: the flipped member gave ok {bad_ok.tolist()}")
    rounds = torch.empty_like(cases[0][3])
    inflate_cu.decode(*cases[0], rounds=rounds)
    per_row = rounds.to(torch.float64)
    print(f"decode: synchronisation rounds per row of the archive: mean "
          f"{float(per_row.mean()):.3f}, max {int(rounds.max())}, rows with none "
          f"{int((rounds == 0).sum())} of {rounds.numel()} [{card}]", flush=True)
    stats = {"decode": check_kernel(torch, "decode", inflate_cu.decode,
                                    inflate_cu.decode_plain, cases, lambda o: o,
                                    card=card, plain_iters=1)}

    # CRC: the decoded members as the round trip's CRC sees them, and rows
    # of lengths around the chunk size, all 130,560 bytes wide
    arr = np.frombuffer(data, np.uint8)
    seg = 130_560
    members = np.zeros((len(huff), seg), np.uint8)
    lengths = np.zeros(len(huff), np.int64)
    for k in range(len(huff)):
        part = arr[k * seg:(k + 1) * seg]
        members[k, :part.size], lengths[k] = part, part.size
    payload = torch.from_numpy(members).to(dev)
    main_chunks = checksum.back_aligned(payload, lengths).reshape(-1, checksum.CRC_CHUNK)
    edge = np.array([0, 1, 255, 256, 257, seg])
    rows_e = np.zeros((edge.size, seg), np.uint8)
    for k, n in enumerate(edge):
        rows_e[k, :n] = arr[:n]
    rows_e = torch.from_numpy(rows_e).to(dev)
    crcs = checksum.crc32_batch_device(rows_e, edge)
    if crcs.tolist() != [zlib.crc32(arr[:n].tobytes()) for n in edge]:
        raise AssertionError("crc32_batch_device differs from zlib.crc32")
    edge_chunks = checksum.back_aligned(rows_e, edge).reshape(-1, checksum.CRC_CHUNK)
    # the library yardstick: the reference's float32 GF(2) product (before
    # its parity) on the unpacked bits
    h = torch.from_numpy(checksum._crc_chunk_matrix()).to(dev).to(torch.float32)
    main_bits = ((main_chunks.to(torch.int32)[:, :, None]
                  >> torch.arange(8, device=dev, dtype=torch.int32)) & 1).reshape(
                      main_chunks.shape[0], -1).to(torch.float32)
    stats["chunk_registers"] = check_kernel(
        torch, "chunk_registers", crc_cu.chunk_registers, crc_cu.chunk_registers_plain,
        [(main_chunks,), (edge_chunks,)], lambda o: (o,), lambda: main_bits @ h, card=card)
    return stats


def main() -> int:
    import torch

    # ---- 1. the card ----
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from decompress_tpu_torch import _build, de

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
    main_path(torch, data, 4, ("mark_path", "histograms", "build_slots"), card)
    wrappers = ("mark_path", "histograms", "litbits", "gain", "build_slots")
    launches = main_path(torch, data, None, wrappers, card)

    # ---- 5. where the time goes ----
    stage_split(torch, data, card)

    # ---- 6. the sharded round trip ----
    archive, sharded_launches = sharded_path(
        torch, data, wrappers + ("decode", "chunk_registers"), card)
    launches.update(decode=sharded_launches["decode"],
                    chunk_registers=sharded_launches["chunk_registers"])

    # ---- 7. the decode and CRC kernels against their plain versions ----
    stats.update(decode_crc_checks(torch, dev, data, archive, card))

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
