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
     each CUDA kernel of a wrapper that launches several; round A's
     candidate search (fields, probe, extend) on the arguments round A
     gives it, the bound counting a probe record by its fields:
     the production batch at levels 6, 4 and 12, with force_exact at
     levels 6 and 4 and a 512-byte window, the B=1 tail batch, an
     all-zero row beside random rows at levels 6, 4 and 12, 3 segments
     of 4,999 bytes (T off the probe tile) at levels 6, 12 and 1, with
     device times at levels 4 and 12; then round A's device kernels a
     batch (fewer than 240 at levels 6 and 12) and its warm wall at
     levels 4, 6 and 12;
  4. the main paths: gz.compress of the 8 MiB corpus (the tests/corpus
     files, sorted, concatenated, repeated, cut) on "cuda" at level 4, then
     at the default level 6 (round B), each checked against the
     reference's size and sha256 and by gzip.decompress; every kernel of
     each path must be launched in that path's run (fields, probe and
     extend as often as each other, at least once a batch), and a CUDA
     tensor that reached the plain version of fields, probe or extend
     would fail the run;
  5. where the time goes: stage walls of three warm level-6 runs (host
     clock, a synchronize around each stage) and one profiled run (device
     busy share, device time by kernel, the port's kernels' share, the
     host-blocking CUDA calls by kind); then the schedule: warm level-6
     walls at de.PIPELINE_DEPTH 1 and 4, interleaved, WALL_RUNS each
     (medians and spreads, each output against the reference's digest),
     and a profiled run at depth 1;
  6. the sharded round trip: sharded_gzip_compress of the corpus at level 6
     (65 members of 130,560 bytes, splits every 8192 bits) checked against
     the reference's size and sha256 and by gzip.decompress, then
     sharded_gzip_decompress of it on the card on both expand routes (the
     default host expansion and expand="device"), each of which must
     return the corpus with the decode kernel launched (and the CRC kernel
     on "device") and no serial fallback; cold and warm walls of both
     halves (the writer on its windowed chunk schedule), the two decode
     routes' warm walls interleaved, the decode's stage split on each
     route, and the CRC stage: its calls a round trip (10), each running
     at most 2 device kernels, and its wall in each half;
  7. the decode and CRC kernels against their plain versions on the card:
     the archive's split rows, one member's rows alone, a fixed-Huffman
     member, a member with one flipped bit (both must reject its final
     row), rows starting before and past a body, the archive with 40 bits
     flipped in every member's first row; the synchronisation rounds per
     row of the archive; crc32_rows against its plain version on the
     decode's 65 payload rows and on edge rows (lengths 0 to 130,560, with
     init values), and against zlib.crc32 on rows with nonzero junk past
     each length, aligned and misaligned (the kernel reads no byte past
     a length);
  8. zlib framing and the one-shot decode: zl.deflate of the corpus at
     level 6 on the card (its five compression kernels launched in its
     run, counts set to 0 just before it) and sharded_zlib_compress of
     it, each checked against the reference's size and sha256 and by
     zlib.decompress and the port's zl.inflate; the port's gz.decompress
     of phase 4's level-6 gzip; cold and warm walls of each; Adler-32 on
     the card (ops.checksum.adler32) against zlib.adler32 on the corpus,
     on lengths 0 to 5,553 and with a start value, with its device time
     L2-warm and cold against its byte bound.
  9. streaming: gz.higher_compress of the corpus in 65,536-byte refills
     (streaming.Deflate, one device analysis per 130,560-byte segment, its
     five compression kernels launched in its run) and the streaming zl.Def
     of it, each checked against the reference's one-shot digest (the
     reference's streaming encoder writes the same bytes) and by stdlib
     zlib, with walls beside the one-shot gz.compress's; zl.Def on the queue
     engine over the corpus's first 1 MiB (64 one-chunk device calls, host
     entropy coding) against the reference's digest; the stage walls and a
     profile of a streaming gz.Def of the first 1 MiB; gz.higher_uncompress
     and zl.Inf of those streams in 64 KiB feeds (host decode walls beside
     the one-shot gz.decompress's); the mark path, histograms, literal bits
     and gains against their plain versions on a real queue-engine batch
     (8 chunk rows of 16,384 bytes, T = 49,152, P = 2^14) and on a streamed
     segment's batch (one row behind its 32 KiB history), with device times;
 10. LZO, the fixed-Huffman step, meshes, two processes and the CLI, each
     output checked against the reference's digest (derived on the CPU by
     scripts/ref_phase10_digests.py): (a) lzo.compress of the corpus at
     level 6 on the card, its cold and warm walls split into the device
     analysis (lzo._analyze) and the host emission, the mark path and
     histograms launched in the warm run, lzo.uncompress of it and the
     host state machine (_uncompress_python) on the first 1 MiB's stream;
     (b) ops.pipeline.fixed_deflate_segments at B = 8, T = 2^17 of the
     corpus's first 1 MiB (no history, bfinal 1): totals and words, each
     row decoded by zlib, both kernels launched, its walls and a profile;
     (c) parallel.compress_step_sharded on make_mesh() and on the card
     twice, equal to (b) in words, sizes and total bits; (d) the level-6
     sharded archive on both meshes (the single-process digest) and with
     shared_tree, each decoded by gzip and on the card on both expand
     routes with no serial fallback; (e) two worker processes on the card (gloo, a file://
     rendezvous in a temporary directory) each writing
     sharded_gzip_compress_multihost of the corpus, both the
     single-process archive, with each rank's walls; (f) the CLI in
     subprocesses, the corpus on stdin: -f gzip, zlib and lzo at level 6
     against their digests, and -d of each back to the corpus;
 11. archives with no bit-stride index, decoded on the card: (a) the
     corpus written with the legacy TS index (SPLIT_BITS 0 on the module
     for the call: 65 members, a triple every 2,048 commands), (b) the
     corpus repeated to 192 MiB (201,326,592 bytes) at the default member
     size, which the writer indexes by member sizes alone (checked); each
     decoded on both expand routes to the input with no serial fallback
     and one decode launch a group (crc32_rows on "device"), cold and warm,
     with interleaved warm walls beside the host gz.decompress of the same
     archive and a stage split of each route; the decode kernel on (a)'s
     TS rows and on (b)'s whole-member rows against its plain version,
     with its device time, bound and synchronisation rounds; and (a) with
     its first member's
     CRC-32 flipped raising the reference's gz.MalformedError("invalid
     checksum") through the serial route, counted once.
The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launches on the path that uses them (the default
level-6 gz.compress for the compression kernels, the sharded round trip
decoded with expand="device" for decode and CRC), errors, times and
bounds (the CRC's: the bytes up to each length read once; the decode's
also at phase 11's whole-member rows); "ms" is a CUDA-event loop of
launches, "device_ms" and "device_cold_ms" the kernels' own device
time from a profile, L2-warm and with the L2 flushed before each launch.
Exits nonzero, with no result, where CUDA is absent.
"""

from __future__ import annotations

import collections
import contextlib
import gzip
import hashlib
import json
import pathlib
import statistics
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
#: the reference's level-6 zl.deflate and sharded_zlib_compress of the corpus
ZL_EXPECT = (2854685, "867f04b6e8d6f5af6af609c852ab2d22819744e0fc20dc097eb7676e72f143a2")
SHARDED_ZL_EXPECT = (2916197, "f99b46c27df2da6404a8ca7dfe04a12e08f66af07efde06eb3e0e483ea0c0c85")
#: the reference's zl.Def(6, engine="queue") of the corpus's first 1 MiB
QUEUE_EXPECT = (411690, "c548d824294e50fdcd45262834290459e959aa7d45f00b181c58a28824bb8461")
#: phase 10, by the reference on the CPU (scripts/ref_phase10_digests.py):
#: lzo.compress level 6 of the corpus, fixed_deflate_segments of its first
#: FIXED_B x FIXED_SEG bytes (totals, sha256 of the little-endian words),
#: and the level-6 sharded archive with shared_tree
LZO_EXPECT = (3414045, "74e5e6531668cb546107e5c87a2640c975ca473e673e91fe8bc6dbd8e92ec4c2")
FIXED_B, FIXED_SEG = 8, 1 << 17
FIXED_TOTALS = (421716, 537445, 546433, 543372, 536824, 536358, 512240, 432550)
FIXED_WORDS_SHA = "88573517f5b1928d0b786c55a0621c023faa573db806bdba79406ddcb8853ab3"
SHARED_EXPECT = (3025290, "a8c31675299b4645f5f7cb918eacce754e0f2a902042aa7b58551eb39cdb9573")
#: seconds a phase-10 worker process or CLI run may take
MULTIHOST_TIMEOUT = 300
CLI_TIMEOUT = 300
#: bytes a streaming refill or decode feed carries
STREAM_PIECE = 65536
#: Adler-32 lengths checked against zlib.adler32 (chunk and NMAX edges)
ADLER_LENGTHS = (0, 1, 511, 512, 513, 5552, 5553)
#: device-memory rate of an H100 SXM (bytes/s), for the kernels' bounds
HBM_BYTES_PER_S = 3.35e12
#: hot-stride distances for the gain checks' hot lane
HOT = (8, 16, 32, 64, 128, 216, 512, 1024)
TIMING_ITERS = 20
#: bytes overwritten between launches for the cold-L2 device times (the
#: H100's L2 holds 50 MB)
FLUSH_BYTES = 64 << 20
#: CUDA runtime calls that hold the host until the device catches up
BLOCKING_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                  "cudaMemcpy")
#: interleaved warm runs of each side of a wall comparison
WALL_RUNS = 5
#: phase 11: the corpus repeated to this size, written with no split index
SIZES_ONLY_BYTES = 192 << 20
#: phase 11: interleaved warm walls of each route on that archive
BIG_WALL_RUNS = 3
#: the CUDA kernels of csrc/ (device-side names in a profile)
PORT_KERNELS = ("chunk_exit_kernel", "chunk_hop_kernel", "chunk_refine_kernel",
                "hist_kernel", "litbits_tally_kernel", "litbits_scan_kernel", "gain_kernel",
                "slots_kernel", "inflate_rows_kernel", "crc_rows_kernel", "fields_kernel",
                "probe_kernel", "extend_kernel")
#: (C-source, TPU kernel or XLA region it replaces) per kernel wrapper
SOURCES = {"mark_path": ("mark_path.cu", "decompress_tpu/ops/parse_pl.py:105"),
           "histograms": ("hist.cu", "decompress_tpu/ops/hist_pl.py:90"),
           "litbits": ("cost.cu", "decompress_tpu/ops/cost_pl.py:246"),
           "gain": ("cost.cu", "decompress_tpu/ops/cost_pl.py:294"),
           "build_slots": ("pack_slots.cu", "decompress_tpu/ops/pack_pl.py:92"),
           "decode": ("inflate.cu", "decompress_tpu/ops/inflate_pl.py:415"),
           "crc32_rows": ("crc.cu", "decompress_tpu/ops/checksum.py:217"),
           "fields": ("probe.cu", "decompress_tpu/ops/lz77.py:283"),
           "probe": ("probe.cu", "decompress_tpu/ops/lz77.py:354"),
           "extend": ("probe.cu", "decompress_tpu/ops/lz77.py:570")}
#: the kernel wrappers every round A launches
ROUND_A = ("fields", "probe", "extend", "mark_path", "histograms")
#: round A's candidate-search wrappers, held against their plain versions
CANDIDATE_SEARCH = ("fields", "probe", "extend")
#: most device kernels one round A of a batch may run at levels 6 and 12:
#: 214 since the fields kernel took the record build's ~220 (436 before)
ROUND_A_KERNELS_MAX = 240


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
    for _ in range(3):  # the profiler now and then records no kernel at all
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        split, kernels = per_call(torch, prof, iters)
        if split:
            break
    return split, kernels


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


def kernel_summary(torch, prof) -> dict:
    """The device kernels of a profile: how many, busy ms (their summed
    durations), the span ms from the first one's start to the last one's
    end, the busy share (busy over span), and ms by kernel name, the
    largest first."""
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    span_us = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels)) if kernels else 0
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return {"device_kernels": len(kernels), "busy_ms": busy_us / 1e3, "span_ms": span_us / 1e3,
            "busy_share": busy_us / max(span_us, 1),
            "by_name_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1]))}


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
                 plain_iters=TIMING_ITERS, moved_bytes=None) -> dict:
    """Kernel == plain version (exactly) on every case; times both, and
    the library call where one computes the same function, on cases[0].
    The bound moves ``moved_bytes``, where given, else every input and
    output tensor once."""
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
                bound_ms=(bound_ms(main_args, kernel(*main_args)) if moved_bytes is None
                          else 1e3 * moved_bytes / HBM_BYTES_PER_S), bound_by="bytes",
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


def corpus_batch(de, dev, arr):
    """The first MAX_DEVICE_BATCH segments of the corpus, staged as the
    one-shot stages them (histories put together on the card) ->
    (d_data, n_valid numpy, nv, hl, b)."""
    seg = de.SEGMENT_SIZE
    rows = de.batch_rows(*de._segments(arr, 0, de.MAX_DEVICE_BATCH, seg), seg)
    batch = de.Batch(rows, dev)
    return batch.data, rows.n_valid, batch.n_valid, batch.hist_len, rows.b


def round_a_kernel_args(torch, lz77, cost_cu, d_data, nv, hl, seg: int) -> dict:
    """The mark path's, histograms', literal bits' and gains' arguments
    from a real level-6 round A of a batch, as round A and round B build
    them."""
    res = lz77.lz77_analyze(d_data, nv, hl, level=6, seg_len=seg)
    take, ln = lz77._take_defer(res["cand_length"], nv, seg, lz77.LEVELS[6].lazy)
    lit = d_data[:, lz77.HIST:]
    lc, dc = (torch.from_numpy(a.astype("i4")).to(d_data.device)
              for a in lz77._cost_tables_host(res["hist_lit"].cpu().numpy(),
                                              res["hist_dist"].cpu().numpy()))
    pay = torch.arange(seg, device=d_data.device)
    length = torch.where(pay < nv[:, None], res["cand_length"], 0)
    _, pref = cost_cu.litbits_pref_plain(lit, lc)
    return {"mark_path": (lz77.jump_array(take, ln, seg, lz77._ceil_pow2(seg)),),
            "histograms": (res["on_path"], res["is_match"], res["length"], res["dist"],
                           lit),
            "litbits": (lit, lc),
            "gain": (length, res["cand_dist"], None, None, pref, lc, dc)}


def captured_args(module, names, fn) -> dict:
    """name -> (args, kwargs) of the last call of each of module's
    functions ``names`` while fn() runs."""
    calls = {}
    originals = {name: getattr(module, name) for name in names}

    def spy(name):
        def call(*args, **kw):
            calls[name] = (args, kw)
            return originals[name](*args, **kw)
        return call

    try:
        for name in originals:
            setattr(module, name, spy(name))
        fn()
    finally:
        for name, f in originals.items():
            setattr(module, name, f)
    return calls


#: round A's candidate-search cases, (batch, lz77_analyze keywords); the
#: first is the one timed, and the card tests run every one
ROUND_A_CASES = (
    ("production", dict(level=6)), ("production", dict(level=4)),
    ("production", dict(level=12)), ("production", dict(level=6, force_exact=True)),
    ("production", dict(level=4, force_exact=True)),
    ("production", dict(level=6, window_bits=9)), ("tail", dict(level=6)),
    ("extremes", dict(level=6)), ("extremes", dict(level=4)),
    ("extremes", dict(level=12)), ("odd", dict(level=6)), ("odd", dict(level=12)),
    ("odd", dict(level=1)))


def round_a_rows(arr, case: str, dev):
    """(data, n_valid, hist_len, seg_len), staged on ``dev`` as the
    compressor stages them, of a round-A batch of the corpus ``arr``: "production" its first 8 segments of 130,560
    bytes behind their 32 KiB history (row 0 with none), "tail" the B = 1
    tail batch (its last, 32,768-byte segment), "odd" 3 segments of 4,999
    bytes (T off the probe tile), "extremes" an all-zero row (every rank
    a hit, runs of 258) with zero history, a random row with random
    history and a random row with none (no hits)."""
    import numpy as np

    from decompress_tpu_torch import de
    from decompress_tpu_torch.ops import lz77

    seg = de.SEGMENT_SIZE
    if case == "extremes":
        rng = np.random.default_rng(1200)
        chunks = [np.zeros(seg, np.uint8), rng.integers(0, 256, seg, dtype=np.uint8),
                  rng.integers(0, 256, seg, dtype=np.uint8)]
        hists = [np.zeros(lz77.HIST, np.uint8),
                 rng.integers(0, 256, lz77.HIST, dtype=np.uint8), chunks[0][:0]]
    else:
        if case == "odd":
            seg = 4999
        starts = {"production": [i * seg for i in range(8)], "tail": [64 * seg],
                  "odd": [12345 + i * seg for i in range(3)]}[case]
        chunks = [arr[s:s + seg] for s in starts]
        hists = [arr[max(0, s - lz77.HIST):s] for s in starts]
    batch = de.Batch(de.batch_rows(chunks, hists, seg), dev)
    return batch.data, batch.n_valid, batch.hist_len, seg


def round_a_calls(torch, dev, arr, case: str, kw: dict) -> dict:
    """The fields', probe's and extend's (args, kwargs) in an eager round
    A (``lz77_analyze.eager``: a replay of its program calls no wrapper)
    of the case's batch on ``dev``."""
    from decompress_tpu_torch.ops import lz77, probe_cu

    *rows, seg = round_a_rows(arr, case, dev)
    return captured_args(probe_cu, CANDIDATE_SEARCH,
                         lambda: lz77.lz77_analyze.eager(*rows, seg_len=seg, **kw))


def record_bytes(args, kw) -> int:
    """Bytes of the probe records a function must move: the R - 1 fields
    a record holds (the key carries the word), not the short ladder's
    padding."""
    from decompress_tpu_torch.ops import probe_cu

    b, t = args[0].shape
    return b * t * 4 * (probe_cu.RECORD_WIDTH[kw["full_ladder"]] - 1)


def candidate_bound_bytes(name, args, kw, out) -> int:
    """The bytes fields, probe or extend must move on these inputs: every
    input read once and every output written once, the records counted
    by their fields (record_bytes)."""
    moved = sum(t.nbytes for t in tensors(args) + tensors(out))
    if name == "fields":
        return moved - out[2].nbytes + record_bytes(args, kw)
    if name == "probe":
        return moved - args[2].nbytes + record_bytes(args, kw)
    return moved


def round_a_checks(torch, dev, arr, production, card) -> dict:
    """Phase 3, round A's candidate search: fields, probe and extend ==
    their plain versions on the arguments round A gives them
    (ROUND_A_CASES), times on the level-6 production batch (the bound
    counting the records by their fields) and device times at levels 4
    and 12; then round A's device kernels and wall a batch at levels 4, 6
    and 12."""
    from decompress_tpu_torch import de
    from decompress_tpu_torch.ops import lz77, probe_cu

    seg = de.SEGMENT_SIZE
    found = [round_a_calls(torch, dev, arr, case, kw) for case, kw in ROUND_A_CASES]
    at_level = {kw["level"]: i for i, (case, kw) in enumerate(ROUND_A_CASES)
                if case == "production" and len(kw) == 1}

    def keyword_call(fn):
        return lambda args, kw: fn(*args, **kw)

    def present(out):  # the output tensors, fields' span tuple flattened
        return tuple(tensors(out))

    stats = {}
    for name in CANDIDATE_SEARCH:
        kernel = keyword_call(getattr(probe_cu, name))
        args = [f[name] for f in found]
        stats[name] = check_kernel(
            torch, name, kernel, keyword_call(getattr(probe_cu, f"{name}_plain")), args,
            present, card=card, plain_iters=3,
            moved_bytes=candidate_bound_bytes(name, *args[0], kernel(*args[0])))
        for level in (4, 12):
            split, _ = device_split(torch, lambda: kernel(*args[at_level[level]]))
            stats[name][f"device_ms_level_{level}"] = sum(split.values())
        print(f"{name}: device ms at level 4 {stats[name]['device_ms_level_4']:.4f}, at "
              f"level 12 {stats[name]['device_ms_level_12']:.4f} [{card}]", flush=True)

    per_level = {}
    for level in (4, 6, 12):
        def call():
            return lz77.lz77_analyze(*production[:3], level=level, seg_len=seg)

        _, kernels = device_split(torch, call, iters=3)
        walls = [timed_call(torch, call)[1] for _ in range(3)]
        per_level[level] = dict(device_kernels=kernels, wall_ms=1e3 * statistics.median(walls))
        print(f"round A (lz77_analyze) of the production batch at level {level}: {kernels} "
              f"device kernels a call, warm wall median {per_level[level]['wall_ms']:.1f} ms "
              f"[{card}]", flush=True)
    over = {lv: v["device_kernels"] for lv, v in per_level.items()
            if lv != 4 and v["device_kernels"] >= ROUND_A_KERNELS_MAX}
    if over:
        raise AssertionError(f"round A ran {over} device kernels a batch, past "
                             f"{ROUND_A_KERNELS_MAX}")
    stats["probe"]["round_a_per_level"] = per_level
    return stats


def program_cases(torch, dev, arr) -> list:
    """(label, program, args, kwargs) of each captured program at the
    main paths' shapes, on ``dev``: round A of the production batch at
    levels 6 and 12 and of the B = 1 tail batch, round B with hot strides
    (HOT), the trims and the re-parse on the level-6 round A, the pack
    with the sharded writer's splits (8 members of 130,560 bytes, no
    history) and the fixed step (B = 8, T = 2^17 of the corpus's first
    1 MiB).  Round B's tables and the pack's come from the host stages
    that feed them."""
    import numpy as np

    from decompress_tpu_torch import de
    from decompress_tpu_torch.ops import lz77, pipeline
    from decompress_tpu_torch.parallel import sharded

    seg = de.SEGMENT_SIZE
    prod = round_a_rows(arr, "production", dev)[:3]
    tail = round_a_rows(arr, "tail", dev)[:3]
    d_data, nv, hl = prod
    res = lz77.lz77_analyze.eager(*prod, level=6, seg_len=seg)
    lc, dc = (torch.from_numpy(a.astype(np.int32)).to(dev) for a in lz77._cost_tables_host(
        res["hist_lit"].cpu().numpy(), res["hist_dist"].cpu().numpy()))
    hot = torch.tensor([HOT] * nv.shape[0], dtype=torch.int32, device=dev)
    trim = (d_data, res["is_match"], res["length"], res["dist"], res["cand_length"],
            res["cand_dist"], nv)

    members = np.frombuffer(arr[:8 * seg].tobytes(), np.uint8).reshape(8, seg)
    m_data, m_nv = torch.from_numpy(members.copy()).to(dev), torch.full(
        (8,), seg, dtype=torch.int32, device=dev)
    m_res = lz77.lz77_analyze.eager(m_data, m_nv, torch.zeros_like(m_nv), level=6,
                                    seg_len=seg, hist=0)
    (hv, hb), tabs, _ = de.plan_blocks(m_res["hist_lit"].cpu().numpy(),
                                       m_res["hist_dist"].cpu().numpy(), np.full(8, seg),
                                       np.zeros(8, bool))
    lit_codes, lit_bits, dist_codes, dist_bits, eob_vals, eob_bits = tabs

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    pack = (m_res["on_path"], m_res["is_match"], m_res["length"], m_res["dist"], m_data,
            put((lit_codes.astype(np.int32) << 4) | lit_bits),
            put((dist_codes.astype(np.int32) << 4) | dist_bits), put(hv.astype(np.int64)),
            put(hb), put(eob_vals.astype(np.int64)), put(eob_bits))

    rows = np.zeros((FIXED_B, lz77.HIST + FIXED_SEG), np.uint8)
    rows[:, lz77.HIST:] = arr[:FIXED_B * FIXED_SEG].reshape(FIXED_B, FIXED_SEG)
    fixed = [put(rows), put(np.full(FIXED_B, FIXED_SEG, np.int32)),
             put(np.zeros(FIXED_B, np.int32)), put(np.ones(FIXED_B, np.int32)),
             *pipeline._fixed_tables(dev)]
    return [
        ("round A, level 6", lz77.lz77_analyze, prod, dict(level=6, seg_len=seg)),
        ("round A, level 12", lz77.lz77_analyze, prod, dict(level=12, seg_len=seg)),
        ("round A, B = 1 tail", lz77.lz77_analyze, tail, dict(level=6, seg_len=seg)),
        ("round B, hot strides", lz77.lz77_parse_cost,
         (d_data, res["cand_length"], res["cand_dist"], nv, lc, dc, hl, hot),
         dict(seg_len=seg, lazy=True)),
        ("trims", lz77.lz77_trim_candidates, trim, dict(seg_len=seg)),
        ("re-parse", lz77.lz77_reparse_greedy,
         (d_data, res["cand_length"], res["cand_dist"], nv), dict(seg_len=seg, two_round=True)),
        ("pack, splits", de.pack_device, pack,
         dict(out_words=(9 * seg) // 32 + 2 * de._HDR_PAD, n_splits=sharded.N_SPLITS,
              split_stride=sharded.SPLIT_STRIDE, split_bits=sharded.SPLIT_BITS)),
        ("fixed step", pipeline.fixed_step, fixed,
         dict(level=6, seg_len=FIXED_SEG, out_words=(10 * FIXED_SEG) // 32 + 64)),
    ]


def program_leaves(out) -> list:
    """The tensors of a program's result, in order."""
    from decompress_tpu_torch.ops import graphs

    leaves: list = []
    graphs._flatten(out, leaves, "result")
    return leaves


def same_leaves(torch, got, want) -> bool:
    g, w = program_leaves(got), program_leaves(want)
    return len(g) == len(w) and all(a.dtype == b.dtype and torch.equal(a, b)
                                    for a, b in zip(g, w))


def describe_key(entry) -> str:
    """A captured program's key, readable: its statics and input shapes."""
    _, statics, _, shapes = entry.key
    stat = ", ".join(f"{k}={v}" for k, v in statics)
    return f"{entry.name}({stat}; {[list(s[0]) for s in shapes]})"


def captured_report(torch, title: str, card) -> None:
    """The captured programs of the card now: each key's capture time and
    graph pool bytes, and their count and sum."""
    from decompress_tpu_torch.ops import graphs

    entries = graphs.captured(0)
    print(f"graphs: {title}: {len(entries)} captured programs, their graph pools "
          f"{sum(e.pool_bytes for e in entries) / 2**20:.1f} MiB [{card}]", flush=True)
    for e in entries:
        print(f"  capture {1e3 * e.capture_s:8.1f} ms  pool {e.pool_bytes / 2**20:7.1f} MiB  "
              f"{describe_key(e)[:150]}", flush=True)


def enqueue_s(torch, fn) -> float:
    """Host seconds until fn() returns, the card idle before it: the time
    the host takes to enqueue fn's work (the call returns before the card
    finishes)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt


def kernels_a_call(torch, fn) -> int:
    """Device kernels a call of fn() in a profile, profiled again where
    the profiler recorded none (device_split retries only where it found
    none of the port's kernels, and some programs launch none)."""
    kernels = 0
    for _ in range(3):
        _, kernels = device_split(torch, fn, iters=3)
        if kernels:
            break
    return kernels


def graph_checks(torch, dev, arr, card) -> dict:
    """Phase 12: every captured program at the main paths' shapes
    (program_cases) replays equal to its eager function, exactly; each
    key's capture time, graph pool bytes, device kernels a replay against
    an eager run, and the host's enqueue of each, interleaved."""
    from decompress_tpu_torch import _build
    from decompress_tpu_torch.ops import graphs

    captured_report(torch, "after phases 3-11", card)
    graphs.clear()
    out = {}
    for label, prog, args, kw in program_cases(torch, dev, arr):
        eager = prog.eager(*args, **kw)
        launches = collections.Counter(_build.LAUNCHES)
        first = prog(*args, **kw)
        eager_launches = _build.LAUNCHES - launches
        entry = graphs.captured(0)[-1]
        replay = prog(*args, **kw)
        torch.cuda.synchronize()
        if not (same_leaves(torch, first, eager) and same_leaves(torch, replay, eager)):
            raise AssertionError(f"graphs: {label}: a replay differs from the eager function")
        if entry.launches != eager_launches:
            raise AssertionError(f"graphs: {label}: the capture counts {dict(entry.launches)} "
                                 f"launches, the eager run {dict(eager_launches)}")
        replay_kernels = kernels_a_call(torch, lambda: prog(*args, **kw))
        eager_kernels = kernels_a_call(torch, lambda: prog.eager(*args, **kw))
        enq = {"replay": [], "eager": []}
        for r in range(WALL_RUNS):
            for side in (("replay", "eager") if r % 2 == 0 else ("eager", "replay")):
                fn = prog if side == "replay" else prog.eager
                enq[side].append(1e3 * enqueue_s(torch, lambda: fn(*args, **kw)))
        stat = dict(capture_ms=1e3 * entry.capture_s, pool_bytes=entry.pool_bytes,
                    launches=dict(entry.launches), replay_kernels=replay_kernels,
                    eager_kernels=eager_kernels,
                    replay_enqueue_ms=statistics.median(enq["replay"]),
                    eager_enqueue_ms=statistics.median(enq["eager"]))
        out[label] = stat
        print(f"graphs: {label}: replay == eager; capture {stat['capture_ms']:.1f} ms, pool "
              f"{entry.pool_bytes / 2**20:.1f} MiB, {replay_kernels} device kernels a replay "
              f"(eager {eager_kernels}), kernel launches a replay {stat['launches']}; host "
              f"enqueue median replay {stat['replay_enqueue_ms']:.3f} ms, eager "
              f"{stat['eager_enqueue_ms']:.3f} ms ({WALL_RUNS} each, interleaved) [{card}]",
              flush=True)

    captured_report(torch, "phase 12", card)
    return out


@contextlib.contextmanager
def no_cuda_in_plain(module, names):
    """Raise where a CUDA tensor reaches one of module's plain versions."""
    originals = {name: getattr(module, name) for name in names}

    def guard(name):
        def call(*args, **kw):
            if any(getattr(a, "is_cuda", False) for a in args):
                raise AssertionError(f"a CUDA tensor reached {module.__name__}.{name}")
            return originals[name](*args, **kw)
        return call

    try:
        for name in names:
            setattr(module, name, guard(name))
        yield
    finally:
        for name, fn in originals.items():
            setattr(module, name, fn)


def kernel_checks(torch, dev, arr, card) -> dict:
    """Phase 3: every kernel == its plain version at the production
    shapes; returns name -> {max_abs_err, ms, plain_ms}."""
    from decompress_tpu_torch import _build, de
    from decompress_tpu_torch.ops import cost_cu, hist_cu, lz77, pack_cu, parse_cu

    seg = de.SEGMENT_SIZE
    d_data, n_valid, nv, hl, b = corpus_batch(de, dev, arr)
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
    gain_args = round_a_kernel_args(torch, lz77, cost_cu, d_data, nv, hl, seg)["gain"]
    length, dist, _, _, pref, lc, dc = gain_args
    hot = torch.tensor([HOT] * b, dtype=torch.int32, device=dev)
    hot_len, hot_d = lz77._hot_lane(d_data, nv, hl, hot, seg_len=seg, hist=lz77.HIST,
                                    max_dist=1 << 15)
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
    stats.update(round_a_checks(torch, dev, arr, [d_data, nv, hl, seg], card))
    return stats


def main_path(torch, data: bytes, level, wrappers, card) -> tuple[dict, bytes]:
    """Phase 4 for one level (None = the default): a warm-up run, then a
    run with every launch count set to 0 just before it; checks the
    bytes and returns the counts of the named ``wrappers`` and the gzip."""
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
    return launches, out


def stage_split(torch, fn, card, title: str = "level-6 gz.compress",
                runs: int = 3) -> None:
    """Per-stage walls of warm runs of fn() (level-6 compression; host
    clock, a synchronize around each stage; the analyze2_finish stage holds
    the host tables, the mining and round B), then one profiled run (device
    busy share, device time by kernel)."""
    from decompress_tpu_torch import de
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
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            parts = ", ".join(f"{stage} {1e3 * s:.1f} ms/{calls[stage]}"
                              for stage, s in spent.items())
            print(f"{title}: stages run {r + 1}: wall {1e3 * wall:.1f} ms; {parts} "
                  f"[{card}]", flush=True)
    finally:
        for label, (mod, attr) in stages.items():
            setattr(mod, attr, originals[label])

    profile_run(torch, fn, card, title)


def spread(walls: list) -> str:
    return (f"median {statistics.median(walls):.4f} s (min {min(walls):.4f}, max "
            f"{max(walls):.4f}, {len(walls)} runs)")


def depth_walls(torch, data: bytes, card) -> None:
    """Phase 5, the schedule: warm level-6 gz.compress walls at
    de.PIPELINE_DEPTH 1 and 4, interleaved (ABBA), each output checked
    against the reference's digest; then one profiled run at depth 1."""
    from decompress_tpu_torch import de, gz

    def run():
        return gz.compress(data, device="cuda")

    saved = de.PIPELINE_DEPTH
    walls = {1: [], 4: []}
    try:
        for r in range(WALL_RUNS):
            for depth in ((1, 4) if r % 2 == 0 else (4, 1)):
                de.PIPELINE_DEPTH = depth
                out, wall = timed_call(torch, run)
                expect(f"level-6 gz.compress at PIPELINE_DEPTH {depth}", out, EXPECT[None])
                walls[depth].append(wall)
        de.PIPELINE_DEPTH = 1
        profile_run(torch, run, card, "level-6 gz.compress at PIPELINE_DEPTH 1")
    finally:
        de.PIPELINE_DEPTH = saved
    for depth, w in walls.items():
        print(f"schedule: level-6 gz.compress warm wall at PIPELINE_DEPTH {depth}: "
              f"{spread(w)} [{card}]", flush=True)
    print(f"schedule: depth 4 / depth 1 median wall "
          f"{statistics.median(walls[4]) / statistics.median(walls[1]):.4f} [{card}]",
          flush=True)


def profile_run(torch, fn, card, title: str) -> None:
    """One profiled run of fn(): its wall, the device's busy share over the
    kernels' span, and device time by kernel (the top 20 and the port's)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    k = kernel_summary(torch, prof)
    print(f"{title}: profile: wall {1e3 * wall:.1f} ms, {k['device_kernels']} device kernels, "
          f"busy {k['busy_ms']:.1f} ms over a {k['span_ms']:.1f} ms span "
          f"({100 * k['busy_share']:.1f}% busy) [{card}]", flush=True)
    runtime = collections.Counter(e.name for e in prof.events() if e.name.startswith("cuda"))
    blocking = {k: runtime[k] for k in BLOCKING_CALLS}
    held = sum(e.time_range.elapsed_us() for e in prof.events() if e.name in BLOCKING_CALLS)
    print(f"{title}: profile: host-blocking CUDA calls in the run {blocking}, the host held "
          f"{held / 1e3:.1f} ms in them (the harness's cudaDeviceSynchronize at the run's "
          f"end included), beside "
          f"{runtime['cudaLaunchKernel']} cudaLaunchKernel, {runtime['cudaMemcpyAsync']} "
          f"cudaMemcpyAsync, {runtime['cudaHostAlloc']} cudaHostAlloc", flush=True)
    top = list(k["by_name_ms"].items())
    ours = [kv for kv in top if port_kernel(kv[0])]
    print(f"{title}: profile: the port's kernels {sum(ms for _, ms in ours):.3f} ms "
          f"of device time", flush=True)
    for kname, ms in top[:20] + ours:
        print(f"  device {ms:8.3f} ms  {kname[:110]}")


def decode_stages(torch, decompress, title: str, runs: int, card) -> None:
    """The sharded decode's stage split: ``runs`` calls of decompress()
    with each stage's function wrapped in a synchronized host-clock timer
    (a stage called once a group adds up over the groups)."""
    from decompress_tpu_torch.ops import checksum, inflate, inflate_cu
    from decompress_tpu_torch.parallel import sharded

    stages = {"host plan (decode_plan)": (sharded, "decode_plan"),
              "staging and tables (stage)": (inflate_cu, "stage"),
              "decode kernel (decode)": (inflate_cu, "decode"),
              "compaction (slot_counts_bits)": (inflate, "slot_counts_bits"),
              "compaction (compact_commands)": (inflate, "compact_commands"),
              "expansion (expand_commands)": (inflate, "expand_commands"),
              "CRC (crc32_batch_device)": (checksum, "crc32_batch_device"),
              "host expansion and CRC (_expand_native)": (sharded, "_expand_native")}
    spent = dict.fromkeys(stages, 0.0)
    originals = {label: getattr(mod, attr) for label, (mod, attr) in stages.items()}

    def stage_timer(label, fn):
        def wrapper(*args, **kw):
            out, dt = timed_call(torch, lambda: fn(*args, **kw))
            spent[label] += dt
            return out
        return wrapper

    for label, (mod, attr) in stages.items():
        setattr(mod, attr, stage_timer(label, originals[label]))
    try:
        for r in range(runs):
            for label in stages:
                spent[label] = 0.0
            _, wall = timed_call(torch, decompress)
            parts = ", ".join(f"{label} {1e3 * t:.1f} ms" for label, t in spent.items() if t)
            print(f"decode stages, {title}, run {r + 1}: wall {1e3 * wall:.1f} ms; {parts} "
                  f"[{card}]", flush=True)
    finally:
        for label, (mod, attr) in stages.items():
            setattr(mod, attr, originals[label])


def sharded_path(torch, data: bytes, wrappers, card):
    """Phase 6: the sharded round trip, each half run cold, then warm with
    every launch count set to 0 just before it; checks the archive against
    the reference's and the round trip, prints walls and the decode's
    stage split.  Returns (archive, launches of both warm halves)."""
    from decompress_tpu_torch import _build
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

    def decompress(expand):
        return sharded.sharded_gzip_decompress(archive, expand=expand, device="cuda")

    def route(expand):
        """One decode route, cold, then warm with every launch count set
        to 0 just before it: (cold s, warm s, launches)."""
        sharded.serial_fallbacks.clear()
        out, cold = timed(lambda: decompress(expand))
        _build.LAUNCHES.clear()
        out, warm = timed(lambda: decompress(expand))
        launches = {name: _build.LAUNCHES[name] for name in wrappers}
        print(f"sharded: sharded_gzip_decompress(expand={expand!r}) -> {len(out)} bytes; "
              f"launches {launches}; serial fallbacks {dict(sharded.serial_fallbacks)}",
              flush=True)
        if out != data:
            raise AssertionError(f"sharded_gzip_decompress(expand={expand!r}) does not "
                                 "restore the input")
        if sharded.serial_fallbacks:
            raise AssertionError(f"serial route taken: {dict(sharded.serial_fallbacks)}")
        need = ("decode", "crc32_rows") if expand == "device" else ("decode",)
        missing = [n for n in need if launches[n] <= 0]
        if missing:
            raise AssertionError(f"decode with expand={expand!r} did not launch {missing}")
        return cold, warm, launches

    cold_d, warm_d, launches_d = route("device")
    cold_n, warm_n, _ = route("auto")
    missing = [n for n, c in launches_c.items() if c <= 0 and n != "decode"]
    if missing:
        raise AssertionError(f"sharded compression did not launch {missing}")
    print(f"sharded wall: compress (windowed chunk schedule) cold {cold_c:.4f} s, warm "
          f"{warm_c:.4f} s = {len(data) / warm_c / 1e6:.2f} MB/s; decompress "
          f"expand='device' cold {cold_d:.4f} s, warm {warm_d:.4f} s = "
          f"{len(data) / warm_d / 1e6:.2f} MB/s; expand='auto' (host expansion) cold "
          f"{cold_n:.4f} s, warm {warm_n:.4f} s = {len(data) / warm_n / 1e6:.2f} MB/s "
          f"[{card}]", flush=True)
    walls = {"device": [], "auto": []}
    for r in range(WALL_RUNS):
        for expand in (("device", "auto") if r % 2 == 0 else ("auto", "device")):
            walls[expand].append(timed(lambda: decompress(expand))[1])
    for expand, w in walls.items():
        print(f"sharded decode warm wall, expand={expand!r}, interleaved: {spread(w)} "
              f"[{card}]", flush=True)

    for expand in ("device", "auto"):
        decode_stages(torch, lambda: decompress(expand), f"expand={expand!r}", 3, card)
    launches = {n: launches_c[n] + launches_d[n] for n in wrappers}
    crc_stage(torch, compress, lambda: decompress("device"), launches["crc32_rows"], card)
    return archive, launches


def crc_stage(torch, compress, decompress, launches: int, card) -> None:
    """The CRC stage of one more round trip: each call's wall (host clock,
    synchronized) by half, then each call replayed TIMING_ITERS times under
    the profiler to count its device kernels a call (copies not counted;
    the memset is; a kernel the profiler recorded counts at least once)."""
    from torch.profiler import ProfilerActivity, profile

    from decompress_tpu_torch.ops import checksum

    crc_batch = checksum.crc32_rows_device  # crc32_batch_device calls it too
    calls = {"compress": [], "decompress": []}
    half = ["compress"]

    def recorded(data_2d, lengths):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = crc_batch(data_2d, lengths)
        torch.cuda.synchronize()
        calls[half[0]].append((data_2d, lengths, time.perf_counter() - t))
        return out

    checksum.crc32_rows_device = recorded
    try:
        compress()
        half[0] = "decompress"
        decompress()
    finally:
        checksum.crc32_rows_device = crc_batch
    kernels = []
    for data_2d, lengths, _ in calls["compress"] + calls["decompress"]:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(TIMING_ITERS):
                crc_batch(data_2d, lengths)
            torch.cuda.synchronize()
        records = collections.Counter(
            e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("Memcpy"))
        kernels.append(sum(max(1, round(n / TIMING_ITERS)) for n in records.values()))
    walls = {h: 1e3 * sum(dt for *_, dt in c) for h, c in calls.items()}
    print(f"sharded CRC stage: {len(kernels)} calls a round trip ({len(calls['compress'])} "
          f"compress, {len(calls['decompress'])} decompress), launches {launches}; device "
          f"kernels a call {kernels}; wall compress {walls['compress']:.3f} ms, decompress "
          f"{walls['decompress']:.3f} ms [{card}]", flush=True)
    if len(kernels) != launches or max(kernels) > 2:
        raise AssertionError("CRC: a call is not one launch of at most 2 device kernels")


def decode_crc_checks(torch, dev, data: bytes, archive: bytes, card) -> dict:
    """Phase 7: the decode and CRC kernels == their plain versions."""
    import zlib

    import numpy as np

    from decompress_tpu_torch.ops import checksum, crc_cu, inflate, inflate_cu
    from decompress_tpu_torch.parallel import sharded

    plan = sharded.decode_plan(np.frombuffer(archive, np.uint8))
    metas, huff, rows, max_cmds = plan.metas, plan.huff, plan.rows, plan.max_cmds()

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

    # CRC: the decoded members as the round trip's CRC sees them (rows of
    # the power-of-two payload width, zero past each length), and edge rows
    arr = np.frombuffer(data, np.uint8)
    seg, width = 130_560, 1 << 17
    members = np.zeros((len(huff), width), np.uint8)
    lengths = np.zeros(len(huff), np.int32)
    for k in range(len(huff)):
        part = arr[k * seg:(k + 1) * seg]
        members[k, :part.size], lengths[k] = part, part.size
    payload = torch.from_numpy(members).to(dev)
    d_lengths = torch.from_numpy(lengths).to(dev)
    edge = np.array([0, 1, 15, 16, 17, 255, 256, 257, 4095, seg], np.int32)
    rows_e = np.zeros((edge.size, seg), np.uint8)
    for k, n in enumerate(edge):
        rows_e[k, :n] = arr[k:k + n]
    rng = np.random.default_rng(7)
    init_e = torch.from_numpy(rng.integers(0, 1 << 32, edge.size)).to(dev)
    crc_cases = [(payload, d_lengths), (torch.from_numpy(rows_e).to(dev),
                                        torch.from_numpy(edge).to(dev), init_e)]
    # zlib on rows with nonzero junk past each length, aligned and not
    junk = np.where(np.arange(seg)[None, :] < edge[:, None], rows_e,
                    rng.integers(1, 256, rows_e.shape, dtype=np.uint8))
    d_junk = torch.from_numpy(junk).to(dev)
    init_h = init_e.cpu().tolist()
    for off in (0, 3):
        lens = np.minimum(edge, seg - off)
        got = crc_cu.crc32_rows(d_junk[:, off:], torch.from_numpy(lens).to(dev), init_e)
        want = [zlib.crc32(junk[k, off:off + n].tobytes(), init_h[k]) for k, n in enumerate(lens)]
        if got.tolist() != want:
            raise AssertionError(f"crc32_rows differs from zlib.crc32 past junk (offset {off})")
    crcs = checksum.crc32_batch_device(payload, lengths)
    if crcs.tolist() != [zlib.crc32(members[k, :n].tobytes()) for k, n in enumerate(lengths)]:
        raise AssertionError("crc32_batch_device differs from zlib.crc32")
    print(f"crc32_rows: equal to zlib.crc32 on {len(huff)} payload rows and on {edge.size} "
          f"rows with junk past each length, at offsets 0 and 3", flush=True)
    # the library yardstick covers only the chunk-register step: the
    # reference's float32 GF(2) product (before its parity) on the unpacked
    # bits of the back-aligned payload
    main_chunks = checksum.back_aligned(payload, lengths).reshape(-1, checksum.CRC_CHUNK)
    h = torch.from_numpy(checksum._crc_chunk_matrix()).to(dev).to(torch.float32)
    main_bits = ((main_chunks.to(torch.int32)[:, :, None]
                  >> torch.arange(8, device=dev, dtype=torch.int32)) & 1).reshape(
                      main_chunks.shape[0], -1).to(torch.float32)
    # the bytes the function must move: each row's bytes up to its length,
    # the lengths, and the int64 results
    moved = int(lengths.sum()) + d_lengths.nbytes + 8 * len(huff)
    stats["crc32_rows"] = check_kernel(
        torch, "crc32_rows", crc_cu.crc32_rows, crc_cu.crc32_rows_plain, crc_cases,
        lambda o: (o,), lambda: main_bits @ h, card=card, moved_bytes=moved)
    stats["crc32_rows"]["library_covers"] = "chunk registers only (float32 bits @ H)"
    if stats["crc32_rows"]["device_kernels_per_call"] > 2:
        raise AssertionError("crc32_rows: a call ran more than 2 device kernels")
    return stats


def timed_call(torch, fn):
    """(fn(), host seconds) with the card synchronized on both sides."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def cold_warm(torch, fn, wrappers=()):
    """fn() run cold, then warm with every launch count set to 0 just
    before it: (output, cold s, warm s, launches of ``wrappers``)."""
    from decompress_tpu_torch import _build

    _, cold = timed_call(torch, fn)
    _build.LAUNCHES.clear()
    out, warm = timed_call(torch, fn)
    return out, cold, warm, {n: _build.LAUNCHES[n] for n in wrappers}


def device_total(torch, fn, flush=None, iters: int = TIMING_ITERS) -> float:
    """Device ms per call of every kernel and copy fn() runs (profiled);
    with ``flush``, flush() runs before each call and its own device time,
    profiled alone, is taken off."""
    from torch.profiler import ProfilerActivity, profile

    def total(f):
        f()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                f()
            torch.cuda.synchronize()
        return sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / iters

    if flush is None:
        return total(fn)
    return total(lambda: (flush(), fn())) - total(flush)


def zlib_path(torch, dev, data: bytes, gz_out: bytes, wrappers, card) -> None:
    """Phase 8: zlib framing on the card, the one-shot host decode, and
    Adler-32 on the card."""
    import zlib

    import numpy as np

    from decompress_tpu_torch import gz, zl
    from decompress_tpu_torch.ops import checksum
    from decompress_tpu_torch.parallel import sharded

    def check(label, out, expect):
        sha = hashlib.sha256(out).hexdigest()
        print(f"zlib: {label} of {len(data)} bytes -> {len(out)} bytes sha256 {sha}",
              flush=True)
        if (len(out), sha) != expect:
            raise AssertionError(f"{label} differs from the reference: {len(out)} "
                                 f"bytes, sha256 {sha}")
        if zlib.decompress(out) != data:
            raise AssertionError(f"zlib.decompress does not restore {label}")

    out, cold, warm, launches = cold_warm(torch, lambda: zl.deflate(data, device="cuda"),
                                          wrappers)
    check("zl.deflate level 6", out, ZL_EXPECT)
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"zl.deflate did not launch {missing}")
    print(f"zlib: zl.deflate launches {launches}; wall cold {cold:.4f} s, warm "
          f"{warm:.4f} s = {len(data) / warm / 1e6:.2f} MB/s [{card}]", flush=True)
    decoded, dcold, dwarm, _ = cold_warm(torch, lambda: zl.inflate(out))
    if decoded != data:
        raise AssertionError("zl.inflate does not restore zl.deflate's stream")

    archive, scold, swarm, slaunches = cold_warm(
        torch, lambda: sharded.sharded_zlib_compress(data, 6, device="cuda"), wrappers)
    check("sharded_zlib_compress level 6", archive, SHARDED_ZL_EXPECT)
    missing = [n for n, c in slaunches.items() if c <= 0]
    if missing:
        raise AssertionError(f"sharded_zlib_compress did not launch {missing}")
    print(f"zlib: sharded_zlib_compress launches {slaunches}; wall cold {scold:.4f} s, "
          f"warm {swarm:.4f} s = {len(data) / swarm / 1e6:.2f} MB/s [{card}]", flush=True)
    sdecoded, sdcold, sdwarm, _ = cold_warm(torch, lambda: zl.inflate(archive))
    if sdecoded != data:
        raise AssertionError("zl.inflate does not restore sharded_zlib_compress's stream")

    gdecoded, gcold, gwarm, _ = cold_warm(torch, lambda: gz.decompress(gz_out))
    if gdecoded != data:
        raise AssertionError("gz.decompress does not restore the level-6 gzip")
    print(f"host decode walls (cold, warm): zl.inflate of zl.deflate's stream {dcold:.4f}, "
          f"{dwarm:.4f} s = {len(data) / dwarm / 1e6:.2f} MB/s; zl.inflate of the sharded "
          f"stream {sdcold:.4f}, {sdwarm:.4f} s; gz.decompress of the level-6 gzip "
          f"{gcold:.4f}, {gwarm:.4f} s = {len(data) / gwarm / 1e6:.2f} MB/s [{card}]",
          flush=True)

    # Adler-32 on the card
    arr = np.frombuffer(data, np.uint8)
    d_data = torch.from_numpy(arr.copy()).to(dev)
    want = zlib.adler32(data)
    got = checksum.adler32(d_data)
    if got != want:
        raise AssertionError(f"adler32 on the card {got:#x} != zlib.adler32 {want:#x}")
    rng = np.random.default_rng(5)
    for n in ADLER_LENGTHS:
        part = data[n:2 * n]
        if checksum.adler32(d_data[n:2 * n]) != zlib.adler32(part):
            raise AssertionError(f"adler32 differs from zlib.adler32 at length {n}")
        start = int(rng.integers(0, 1 << 32))
        if checksum.adler32(part, start, device="cuda") != zlib.adler32(part, start):
            raise AssertionError(f"adler32 with a start value differs at length {n}")
        if checksum.adler32(b"\xff" * n, device="cuda") != zlib.adler32(b"\xff" * n):
            raise AssertionError(f"adler32 of 0xff bytes differs at length {n}")
    ms = time_ms(torch, lambda: checksum.adler32(d_data))
    scratch = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    warm_dev = device_total(torch, lambda: checksum.adler32(d_data))
    cold_dev = device_total(torch, lambda: checksum.adler32(d_data),
                            flush=lambda: scratch.fill_(1))
    bound = 1e3 * (d_data.nbytes + 8) / HBM_BYTES_PER_S
    print(f"adler32: equal to zlib.adler32 on the corpus and on lengths "
          f"{list(ADLER_LENGTHS)} (with start values, and of 0xff bytes); on the card "
          f"{ms:.4f} ms (device {warm_dev:.4f} ms L2-warm, {cold_dev:.4f} ms cold; every "
          f"kernel and copy), bound {bound:.4f} ms [{card}]", flush=True)


def streaming_path(torch, dev, data: bytes, wrappers, card) -> None:
    """Phase 9: the streaming encoders and decoders on the card's port,
    and four kernels at the streaming shapes."""
    import zlib

    from decompress_tpu_torch import _build, de, gz, zl
    from decompress_tpu_torch.ops import cost_cu, hist_cu, lz77, parse_cu

    analyses = [0]
    start = lz77.analyze2_start  # one a device analysis (``de.Batch.start``)

    def counted(*args, **kw):
        analyses[0] += 1
        return start(*args, **kw)

    def refills(x):
        pieces = iter([x[i:i + STREAM_PIECE] for i in range(0, len(x), STREAM_PIECE)])
        return lambda: next(pieces, b"")

    def stream_gz():
        out = []
        gz.higher_compress(refills(data), out.append)
        return b"".join(out)

    def stream_zl(x, **kw):
        enc = zl.Def(6, **kw)
        return b"".join(enc.push(x[i:i + STREAM_PIECE])
                        for i in range(0, len(x), STREAM_PIECE)) + enc.finish()

    def check(label, out, expect, x, decompress):
        sha = hashlib.sha256(out).hexdigest()
        print(f"streaming: {label} of {len(x)} bytes -> {len(out)} bytes sha256 {sha}",
              flush=True)
        if (len(out), sha) != expect:
            raise AssertionError(f"{label} differs from the reference: {len(out)} "
                                 f"bytes, sha256 {sha}")
        if decompress(out) != x:
            raise AssertionError(f"stdlib zlib does not restore {label}")

    def launched(label, launches, names):
        missing = [n for n in names if launches[n] <= 0]
        if missing:
            raise AssertionError(f"{label} did not launch {missing}")

    lz77.analyze2_start = counted
    try:
        gz_out, cold, warm, launches = cold_warm(torch, stream_gz, wrappers)
        n_gz = analyses[0] // 2
        check("gz.higher_compress (segment engine)", gz_out, EXPECT[None], data,
              gzip.decompress)
        launched("gz.higher_compress", launches, wrappers)
        _, one_shot = timed_call(torch, lambda: gz.compress(data, device="cuda"))
        print(f"streaming: gz.higher_compress launches {launches}; {n_gz} device "
              f"analyses a run; wall cold {cold:.4f} s, warm {warm:.4f} s = "
              f"{len(data) / warm / 1e6:.2f} MB/s; one-shot gz.compress warm "
              f"{one_shot:.4f} s (streaming / one-shot {warm / one_shot:.2f}) [{card}]",
              flush=True)

        analyses[0] = 0
        _build.LAUNCHES.clear()
        zl_out, zl_s = timed_call(torch, lambda: stream_zl(data))
        check("zl.Def (segment engine)", zl_out, ZL_EXPECT, data, zlib.decompress)
        launched("zl.Def", _build.LAUNCHES, wrappers)
        print(f"streaming: zl.Def {analyses[0]} device analyses; wall {zl_s:.4f} s = "
              f"{len(data) / zl_s / 1e6:.2f} MB/s [{card}]", flush=True)

        head = data[:1 << 20]
        analyses[0] = 0
        _build.LAUNCHES.clear()
        q_out, q_s = timed_call(torch, lambda: stream_zl(head, engine="queue"))
        check("zl.Def (queue engine)", q_out, QUEUE_EXPECT, head, zlib.decompress)
        q_launches = {n: _build.LAUNCHES[n] for n in wrappers}
        launched("zl.Def (queue engine)", q_launches,
                 [n for n in wrappers if n != "build_slots"])
        print(f"streaming: zl.Def queue engine launches {q_launches}; {analyses[0]} "
              f"device calls; wall {q_s:.4f} s = {len(head) / q_s / 1e6:.2f} MB/s "
              f"[{card}]", flush=True)
    finally:
        lz77.analyze2_start = start

    def stream_head():
        enc = gz.Def(6)
        return enc.push(head) + enc.finish()

    stage_split(torch, stream_head, card, "streaming gz.Def of the first 1 MiB", runs=2)

    def uncompress_gz():
        out = []
        gz.higher_uncompress(refills(gz_out), out.append, STREAM_PIECE)
        return b"".join(out)

    def inflate_zl():
        dec, out = zl.Inf(STREAM_PIECE), []
        feed = refills(zl_out)
        while (tok := dec.decode()) != "end":
            if tok == "await":
                dec.src(feed())
            elif tok == "flush":
                out.append(dec.flush())
            else:
                raise AssertionError(f"zl.Inf: {dec.error}")
        out.append(dec.flush())
        return b"".join(out)

    walls = {}
    for label, fn in [("gz.higher_uncompress", uncompress_gz), ("zl.Inf", inflate_zl),
                      ("one-shot gz.decompress", lambda: gz.decompress(gz_out))]:
        out, dcold, dwarm, _ = cold_warm(torch, fn)
        if out != data:
            raise AssertionError(f"{label} does not restore the corpus")
        walls[label] = f"{dcold:.4f}, {dwarm:.4f} s = {len(data) / dwarm / 1e6:.2f} MB/s"
    print("streaming decode walls (cold, warm): " + "; ".join(
        f"{k} {v}" for k, v in walls.items()) + f" [{card}]", flush=True)

    # the kernels at the streaming shapes
    raw = de._np_u8(data)
    chunk = 16384
    starts = [1 << 20] + [(1 << 20) + chunk * i for i in range(1, de.MAX_DEVICE_BATCH)]
    rows = de.Batch(de.batch_rows([raw[s:s + chunk] for s in starts],
                                  [raw[s - lz77.HIST:s] for s in starts], chunk), dev)
    seg = de.SEGMENT_SIZE
    one = de.Batch(de.batch_rows([raw[3 * seg:4 * seg]], [raw[3 * seg - lz77.HIST:3 * seg]],
                                 seg), dev)
    plain = {"mark_path": (parse_cu.mark_path, parse_cu.mark_path_plain, lambda o: (o,)),
             "histograms": (hist_cu.histograms, hist_cu.histograms_plain, lambda o: o),
             "litbits": (cost_cu.litbits_pref, cost_cu.litbits_pref_plain, lambda o: o),
             "gain": (cost_cu.gain, cost_cu.gain_plain, lambda o: o)}
    for label, batch, seg_len in [
            ("queue-engine batch (B=8, T=49,152, P=2^14)", rows, chunk),
            ("streamed segment (B=1, T=163,328, P=2^17)", one, seg)]:
        args = round_a_kernel_args(torch, lz77, cost_cu, batch.data, batch.n_valid,
                                   batch.hist_len, seg_len)
        for name, (kernel, plain_fn, norm) in plain.items():
            stat = check_kernel(torch, f"{name} at the {label}", kernel, plain_fn,
                                [args[name]], norm, card=card, plain_iters=3)
            print(f"streaming shapes: {name} at the {label}: device "
                  f"{stat['device_ms']:.4f} ms warm, {stat['device_cold_ms']:.4f} ms "
                  f"cold, bound {stat['bound_ms']:.4f} ms [{card}]", flush=True)

#: phase 10's two-process worker: argv = rendezvous URI, rank, archive path
_MULTIHOST_WORKER = """
import sys, time
sys.path.insert(0, sys.argv[4])
import torch
import chip_smoke
from decompress_tpu_torch import _build
from decompress_tpu_torch.parallel import multihost

init, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
multihost.initialize(init, 2, rank)
data = chip_smoke.corpus_bytes()
walls = []
for _ in range(2):  # cold, then warm with the launch counts set to 0
    _build.LAUNCHES.clear()
    torch.cuda.synchronize()
    t = time.perf_counter()
    arch = multihost.sharded_gzip_compress_multihost(data, 6)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t)
with open(out, "wb") as f:
    f.write(arch)
print(f"rank {rank}: {len(arch)} bytes, wall cold {walls[0]:.4f} s, warm {walls[1]:.4f} s; "
      f"launches {dict(sorted(_build.LAUNCHES.items()))}")
torch.distributed.destroy_process_group()
"""


def digest_of(out: bytes) -> tuple[int, str]:
    return len(out), hashlib.sha256(out).hexdigest()


def expect(label: str, out: bytes, want: tuple[int, str]) -> None:
    """Raise unless ``out`` has the reference's size and sha256."""
    got = digest_of(out)
    print(f"{label}: {got[0]} bytes sha256 {got[1]}", flush=True)
    if got != want:
        raise AssertionError(f"{label} differs from the reference: {got}")


def lzo_path(torch, data: bytes, card) -> dict:
    """Phase 10a: lzo.compress of the corpus on the card, its analysis and
    emission walls apart; both decoders restore it."""
    from decompress_tpu_torch import _build, lzo

    analyze = lzo._analyze
    spent = [0.0]

    def timed_analyze(*args, **kw):
        out, dt = timed_call(torch, lambda: analyze(*args, **kw))
        spent[0] += dt
        return out

    def run():
        spent[0] = 0.0
        out, wall = timed_call(torch, lambda: lzo.compress(data, level=6, device="cuda"))
        return out, wall, spent[0]

    lzo._analyze = timed_analyze
    try:
        _, cold, cold_an = run()
        _build.LAUNCHES.clear()
        out, warm, warm_an = run()
        launches = {n: _build.LAUNCHES[n] for n in ROUND_A}
    finally:
        lzo._analyze = analyze
    expect("lzo: lzo.compress level 6", out, LZO_EXPECT)
    if [n for n, c in launches.items() if c <= 0]:
        raise AssertionError(f"lzo.compress did not launch round A's kernels: {launches}")
    print(f"lzo: launches {launches}; wall cold {cold:.4f} s (analysis {cold_an:.4f}, "
          f"emission {cold - cold_an:.4f}), warm {warm:.4f} s (analysis {warm_an:.4f}, "
          f"emission {warm - warm_an:.4f}) = {len(data) / warm / 1e6:.2f} MB/s [{card}]",
          flush=True)
    back, dec = timed_call(torch, lambda: lzo.uncompress(out))
    if back != data:
        raise AssertionError("lzo.uncompress does not restore the corpus")
    head = data[:1 << 20]
    head_c, head_s = timed_call(torch, lambda: lzo.compress(head, level=6, device="cuda"))
    back, py_s = timed_call(torch, lambda: lzo._uncompress_python(head_c))
    if back != head:
        raise AssertionError("lzo._uncompress_python does not restore the first 1 MiB")
    print(f"lzo: uncompress (native) of the corpus {dec:.4f} s; the first 1 MiB: "
          f"compress {head_s:.4f} s, decode by the host state machine {py_s:.4f} s "
          f"[{card}]", flush=True)
    return launches


def fixed_step_path(torch, dev, data: bytes, card):
    """Phase 10b and c: fixed_deflate_segments of the corpus's first
    FIXED_B x FIXED_SEG bytes, each row decoded by zlib; then
    compress_step_sharded on make_mesh() and on the card twice."""
    import zlib

    import numpy as np

    from decompress_tpu_torch import _build, parallel
    from decompress_tpu_torch.ops import bitpack, lz77, pipeline

    rows = np.zeros((FIXED_B, lz77.HIST + FIXED_SEG), np.uint8)
    rows[:, lz77.HIST:] = np.frombuffer(data[:FIXED_B * FIXED_SEG], np.uint8).reshape(
        FIXED_B, FIXED_SEG)
    n = np.full(FIXED_B, FIXED_SEG, np.int32)
    zero, one = np.zeros(FIXED_B, np.int32), np.ones(FIXED_B, np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (rows, n, zero, one)]

    def step():
        return pipeline.fixed_deflate_segments(*args, level=6, seg_len=FIXED_SEG)

    _, cold, warm, launches = cold_warm(torch, step, ROUND_A)
    words, bits = step()
    raw = words.cpu().view(torch.int32).numpy().astype("<i4").tobytes()
    sha = hashlib.sha256(raw).hexdigest()
    print(f"fixed step: B={FIXED_B} seg_len={FIXED_SEG}: totals {bits.tolist()}, words "
          f"sha256 {sha}; launches {launches}", flush=True)
    if bits.tolist() != list(FIXED_TOTALS) or sha != FIXED_WORDS_SHA:
        raise AssertionError("fixed_deflate_segments differs from the reference")
    if [k for k, c in launches.items() if c <= 0]:
        raise AssertionError(f"fixed_deflate_segments did not launch round A's kernels: "
                             f"{launches}")
    for i in range(FIXED_B):
        body = bitpack.words_to_bytes(words[i], int(bits[i]))
        if zlib.decompressobj(-15).decompress(body) != rows[i, lz77.HIST:].tobytes():
            raise AssertionError(f"fixed step row {i} does not decode to its payload")
    print(f"fixed step: every row decodes with zlib; wall cold {cold:.4f} s, warm "
          f"{1e3 * warm:.1f} ms = {FIXED_B * FIXED_SEG / warm / 1e6:.2f} MB/s [{card}]",
          flush=True)
    profile_run(torch, step, card, "fixed step")

    for mesh in (parallel.make_mesh(), (dev, dev)):
        _build.LAUNCHES.clear()
        (w, sizes_all, total), s_wall = timed_call(
            torch, lambda: parallel.compress_step_sharded(mesh, *args, level=6,
                                                          seg_len=FIXED_SEG))
        nd = len(mesh)
        want_sizes = bits.reshape(nd, FIXED_B // nd).repeat(1, nd)
        if not (torch.equal(w, words) and torch.equal(sizes_all, want_sizes)
                and int(total) == int(bits.sum())):
            raise AssertionError(f"compress_step_sharded on {nd} devices differs from (b)")
        print(f"compress_step_sharded on {nd} device(s) {[str(d) for d in mesh]}: equal to "
              f"(b), total_bits {int(total)}; launches "
              f"{ {k: _build.LAUNCHES[k] for k in ROUND_A} }; "
              f"wall {1e3 * s_wall:.1f} ms [{card}]", flush=True)


def mesh_path(torch, dev, data: bytes, card) -> None:
    """Phase 10d: the mesh archives on make_mesh() and on the card twice,
    and the shared-tree archive, each decoded by gzip and on the card."""
    from decompress_tpu_torch import _build, parallel
    from decompress_tpu_torch.parallel import sharded

    wrappers = ("mark_path", "histograms", "litbits", "gain", "build_slots", "crc32_rows")
    for label, mesh, kw, want in [
            ("make_mesh()", parallel.make_mesh(), {}, SHARDED_EXPECT),
            ("(cuda:0, cuda:0)", (dev, dev), {}, SHARDED_EXPECT),
            ("make_mesh(), shared_tree", parallel.make_mesh(), {"shared_tree": True},
             SHARED_EXPECT)]:
        archive, cold, warm, launches = cold_warm(
            torch, lambda: sharded.sharded_gzip_compress(data, 6, mesh=mesh, **kw), wrappers)
        expect(f"mesh: sharded_gzip_compress on {label}", archive, want)
        if [k for k, c in launches.items() if c <= 0]:
            raise AssertionError(f"mesh archive on {label} did not launch {launches}")
        if gzip.decompress(archive) != data:
            raise AssertionError(f"gzip.decompress does not restore the archive on {label}")
        decoded = []
        for expand, need in (("auto", ("decode",)), ("device", ("decode", "crc32_rows"))):
            sharded.serial_fallbacks.clear()
            _build.LAUNCHES.clear()
            back, d_wall = timed_call(torch, lambda: sharded.sharded_gzip_decompress(
                archive, expand=expand, device="cuda"))
            d_launches = {k: _build.LAUNCHES[k] for k in ("decode", "crc32_rows")}
            if back != data or sharded.serial_fallbacks or min(d_launches[k] for k in need) <= 0:
                raise AssertionError(f"sharded_gzip_decompress(expand={expand!r}) of the "
                                     f"archive on {label}: serial fallbacks "
                                     f"{dict(sharded.serial_fallbacks)}, launches {d_launches}")
            decoded.append(f"expand={expand!r} {d_wall:.4f} s, launches {d_launches}")
        print(f"mesh: {label}: launches {launches}; compress wall cold {cold:.4f} s, warm "
              f"{warm:.4f} s; card decode {'; '.join(decoded)}, no serial fallback "
              f"[{card}]", flush=True)


def multiprocess_path(card) -> None:
    """Phase 10e: two processes on the card (gloo, a file:// rendezvous in
    a temporary directory), each writing sharded_gzip_compress_multihost of
    the corpus; both archives must be the single-process archive."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        init = pathlib.Path(tmp, "rendezvous").as_uri()
        outs = [pathlib.Path(tmp, f"rank{r}.gz") for r in range(2)]
        env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get(
            "PYTHONPATH", ""))
        procs = [subprocess.Popen(
            [sys.executable, "-c", _MULTIHOST_WORKER, init, str(r), str(outs[r]), str(ROOT)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]
        try:
            logs = [p.communicate(timeout=MULTIHOST_TIMEOUT) for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for r, (p, (out, err)) in enumerate(zip(procs, logs)):
            print(out.strip(), flush=True)
            if p.returncode != 0:
                raise AssertionError(f"rank {r} failed ({p.returncode}): {err[-2000:]}")
        for r in range(2):
            expect(f"two processes: rank {r}'s archive", outs[r].read_bytes(),
                   SHARDED_EXPECT)
    print(f"two processes: both ranks wrote the single-process archive [{card}]", flush=True)


def cli_path(data: bytes, card) -> None:
    """Phase 10f: python -m decompress_tpu_torch.cli on the card, the
    corpus on stdin, in each direction."""
    def run(args, stdin):
        t = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "decompress_tpu_torch.cli", *args],
                           input=stdin, capture_output=True, cwd=ROOT, timeout=CLI_TIMEOUT)
        wall = time.perf_counter() - t
        if p.returncode != 0:
            raise AssertionError(f"cli {args} failed: {p.stderr.decode()[-2000:]}")
        return p.stdout, wall

    for fmt, want in [("gzip", EXPECT[None]), ("zlib", ZL_EXPECT), ("lzo", LZO_EXPECT)]:
        out, c_wall = run(["-f", fmt, "-l", "6"], data)
        expect(f"cli: -f {fmt} -l 6", out, want)
        back, d_wall = run(["-d", "-f", fmt], out)
        if back != data:
            raise AssertionError(f"cli -d -f {fmt} does not restore the corpus")
        print(f"cli: -f {fmt}: compress {c_wall:.4f} s, -d {d_wall:.4f} s (process walls) "
              f"[{card}]", flush=True)


def decode_routes(torch, label: str, archive: bytes, want: bytes, card, runs: int) -> int:
    """Both expand routes of one archive's decode on the card, each cold,
    then warm with the counts set to 0 just before it (the decode launched
    once a group, crc32_rows on "device", no serial fallback and no card
    retry); ``runs`` interleaved warm walls of each route and of the host
    gz.decompress of the same archive; one stage split of each route.
    Returns the decode launches counted in the warm "device" run."""
    import numpy as np

    from decompress_tpu_torch import _build, gz
    from decompress_tpu_torch.parallel import sharded

    groups = len(sharded._groups(sharded.decode_plan(np.frombuffer(archive, np.uint8))))

    def run(route):
        if route == "host":
            return gz.decompress(archive)
        return sharded.sharded_gzip_decompress(archive, expand=route, device="cuda")

    measured = {}
    for expand in ("device", "auto"):
        sharded.serial_fallbacks.clear()
        sharded.card_retries.clear()
        _, cold = timed_call(torch, lambda: run(expand))
        _build.LAUNCHES.clear()
        out, warm = timed_call(torch, lambda: run(expand))
        launches = {n: _build.LAUNCHES[n] for n in ("decode", "crc32_rows")}
        measured[expand] = launches["decode"]
        print(f"{label}: sharded_gzip_decompress(expand={expand!r}) -> {len(out)} bytes; "
              f"launches {launches} for {groups} groups; serial fallbacks "
              f"{dict(sharded.serial_fallbacks)}, card retries {dict(sharded.card_retries)}; "
              f"cold {cold:.4f} s, warm {warm:.4f} s [{card}]", flush=True)
        if out != want:
            raise AssertionError(f"{label}: expand={expand!r} does not restore the input")
        if sharded.serial_fallbacks or sharded.card_retries:
            raise AssertionError(f"{label}: serial route or card retry taken: "
                                 f"{dict(sharded.serial_fallbacks)} {dict(sharded.card_retries)}")
        if launches["decode"] != groups or (expand == "device" and launches["crc32_rows"] <= 0):
            raise AssertionError(f"{label}: expand={expand!r} launched {launches} for "
                                 f"{groups} groups")
    walls = {"device": [], "auto": [], "host": []}
    for r in range(runs):
        for route in (("device", "auto", "host") if r % 2 == 0 else ("host", "auto", "device")):
            out, wall = timed_call(torch, lambda: run(route))
            if out != want:
                raise AssertionError(f"{label}: the {route} route does not restore the input")
            walls[route].append(wall)
    for route, w in walls.items():
        name = "host gz.decompress" if route == "host" else f"expand={route!r}"
        print(f"{label}: warm wall, {name}, interleaved: {spread(w)} = "
              f"{len(want) / statistics.median(w) / 1e6:.2f} MB/s [{card}]", flush=True)
    for expand in ("device", "auto"):
        decode_stages(torch, lambda: run(expand), f"{label}, expand={expand!r}", 1, card)
    return measured["device"]


def decode_kernel_at(torch, plan, dev, label: str, card) -> dict:
    """The decode kernel on every row of an archive's plan, against its
    plain version on the same inputs; its device ms L2-warm and cold, its
    bound (the bodies read once, the commands written once), and the
    rows' synchronisation rounds."""
    from decompress_tpu_torch.ops import inflate_cu

    huff, metas = plan.huff, plan.metas
    st = inflate_cu.stage([metas[i][1] for i in huff], [metas[i][0][1] for i in huff],
                          [metas[i][0][2] for i in huff], plan.rows, dev)
    args = (st["words"], st["tabs"], st["row_ptr"], st["start"], st["stop"], st["nbits"],
            st["blocks"], plan.max_cmds())
    rounds = torch.empty_like(st["start"])
    got = inflate_cu.decode(*args, rounds=rounds)
    want, plain_s = timed_call(torch, lambda: inflate_cu.decode_plain(*args))
    err = max_abs_err(torch, got, want)
    if err or not bool(got[1].all()):
        raise AssertionError(f"decode on {label}: max |err| {err} against plain, "
                             f"ok {bool(got[1].all())}")
    ms = time_ms(torch, lambda: inflate_cu.decode(*args), iters=5, warmup=1)
    warm, _ = device_split(torch, lambda: inflate_cu.decode(*args), iters=5)
    scratch = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    cold, _ = device_split(torch, lambda: inflate_cu.decode(*args), iters=5,
                           flush=lambda: scratch.fill_(1))
    moved = sum(metas[i][1].size for i in huff) + 4 * int(got[2].sum())
    # None where the profiler recorded no kernel (it now and then records none)
    stat = dict(rows=int(st["start"].numel()), max_cmds=plan.max_cmds(), max_abs_err=err, ms=ms,
                device_ms=sum(warm.values()) if warm else None,
                device_cold_ms=sum(cold.values()) if cold else None,
                plain_ms=1e3 * plain_s, bound_ms=1e3 * moved / HBM_BYTES_PER_S,
                bound_by="bytes", mean_rounds=float(rounds.to(torch.float64).mean()),
                max_rounds=int(rounds.max()))
    warm_s, cold_s = ("not recorded" if v is None else f"{v:.4f} ms"
                      for v in (stat["device_ms"], stat["device_cold_ms"]))
    print(f"decode, {label}: {stat['rows']} rows of {len(huff)} members (max_cmds "
          f"{stat['max_cmds']}), equal to plain; kernel {ms:.4f} ms (device "
          f"{warm_s} L2-warm, {cold_s} cold), plain "
          f"{stat['plain_ms']:.1f} ms, bound {stat['bound_ms']:.4f} ms ({moved} bytes); "
          f"synchronisation rounds per row mean {stat['mean_rounds']:.3f}, max "
          f"{stat['max_rounds']} [{card}]", flush=True)
    return stat


def index_kinds_path(torch, dev, data: bytes, card) -> dict:
    """Phase 11: archives with no bit-stride index, decoded on the card.
    (a) the corpus written with the legacy TS index (SPLIT_BITS 0 on the
    module for the call), its decode routes, the decode kernel on its
    rows, and one member's CRC-32 flipped (the reference's error through
    the counted serial route);
    (b) the corpus repeated to SIZES_ONLY_BYTES, written at the default
    member size (the writer falls back to the member sizes alone), its
    decode routes, and the decode kernel on its whole-member rows.
    Returns the whole-member kernel's numbers."""
    import numpy as np

    from decompress_tpu_torch import gz
    from decompress_tpu_torch.parallel import sharded

    saved = sharded.SPLIT_BITS
    sharded.SPLIT_BITS = 0
    try:
        ts, wall = timed_call(torch, lambda: sharded.sharded_gzip_compress(data, 6, device="cuda"))
    finally:
        sharded.SPLIT_BITS = saved
    buf = np.frombuffer(ts, np.uint8)
    sizes, splits, tb = sharded._read_index_ex(buf)
    if tb is not None or splits is None or gzip.decompress(ts) != data:
        raise AssertionError("the SPLIT_BITS 0 archive is not a TS-indexed archive of the input")
    plan = sharded.decode_plan(buf)
    print(f"index kinds: TS archive of {len(data)} bytes -> {len(ts)} bytes in {wall:.4f} s "
          f"(cold), {len(plan.huff)} members, {sum(map(len, plan.rows))} rows, max_cmds "
          f"{plan.max_cmds()} [{card}]", flush=True)
    decode_routes(torch, "TS 8 MiB", ts, data, card, WALL_RUNS)
    decode_kernel_at(torch, plan, dev, "TS rows", card)
    bad = bytearray(ts)
    bad[sizes[0] - 5] ^= 1  # the first member's CRC-32
    sharded.serial_fallbacks.clear()
    sharded.card_retries.clear()
    try:
        sharded.sharded_gzip_decompress(bytes(bad), device="cuda")
        raise AssertionError("a flipped member CRC-32 decoded")
    except gz.MalformedError as e:
        if str(e) != "invalid checksum":
            raise
    counted = {"member length or CRC-32 mismatch": 1}
    if dict(sharded.serial_fallbacks) != counted or dict(sharded.card_retries) != counted:
        raise AssertionError(f"reject counted as {dict(sharded.serial_fallbacks)}, "
                             f"{dict(sharded.card_retries)}")
    print("index kinds: TS archive with the first member's CRC-32 flipped: the member decoded "
          "again whole on the card, then gz.MalformedError('invalid checksum') by the serial "
          f"route; card retries {dict(sharded.card_retries)}, serial fallbacks "
          f"{dict(sharded.serial_fallbacks)}", flush=True)

    big = (data * -(-SIZES_ONLY_BYTES // len(data)))[:SIZES_ONLY_BYTES]
    arch, wall = timed_call(torch, lambda: sharded.sharded_gzip_compress(big, 6, device="cuda"))
    buf = np.frombuffer(arch, np.uint8)
    if sharded._read_index_ex(buf)[1] is not None:
        raise AssertionError("the large archive carries a split subfield")
    if gzip.decompress(arch) != big:
        raise AssertionError("gzip.decompress does not restore the large archive")
    plan = sharded.decode_plan(buf)
    print(f"index kinds: sizes-only archive of {len(big)} bytes -> {len(arch)} bytes in "
          f"{wall:.4f} s (cold, {len(big) / wall / 1e6:.2f} MB/s), {len(plan.huff)} members of "
          f"one row each, max_cmds {plan.max_cmds()}, {len(sharded._groups(plan))} groups "
          f"[{card}]", flush=True)
    launches = decode_routes(torch, "sizes-only 192 MiB", arch, big, card, BIG_WALL_RUNS)
    return dict(decode_kernel_at(torch, plan, dev, "whole-member rows", card),
                launches=launches)


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
    from decompress_tpu_torch import native

    t0 = time.perf_counter()
    print(f"build: native {native.build()} in {time.perf_counter() - t0:.3f} s", flush=True)

    data = corpus_bytes()

    # ---- 3. kernels against their plain versions, production shapes ----
    stats = kernel_checks(torch, dev, de._np_u8(data), card)

    # ---- 4. the main paths: level 4, then the default level 6 ----
    from decompress_tpu_torch.ops import probe_cu

    wrappers = ("mark_path", "histograms", "litbits", "gain", "build_slots", "fields", "probe",
                "extend")
    with no_cuda_in_plain(probe_cu, ("fields_plain", "probe_plain", "extend_plain")):
        main_path(torch, data, 4, ROUND_A + ("build_slots",), card)
        launches, gz_out = main_path(torch, data, None, wrappers, card)
    if not launches["fields"] == launches["probe"] == launches["extend"] >= 9:
        raise AssertionError(f"the level-6 path ran round A's kernels {launches['fields']}, "
                             f"{launches['probe']} and {launches['extend']} times for its 9 "
                             f"batches")

    # ---- 5. where the time goes ----
    from decompress_tpu_torch import gz

    stage_split(torch, lambda: gz.compress(data, device="cuda"), card)
    depth_walls(torch, data, card)

    # ---- 6. the sharded round trip ----
    archive, sharded_launches = sharded_path(
        torch, data, wrappers + ("decode", "crc32_rows"), card)
    launches.update(decode=sharded_launches["decode"],
                    crc32_rows=sharded_launches["crc32_rows"])

    # ---- 7. the decode and CRC kernels against their plain versions ----
    stats.update(decode_crc_checks(torch, dev, data, archive, card))

    # ---- 8. zlib framing, the one-shot host decode, Adler-32 ----
    zlib_path(torch, dev, data, gz_out, wrappers, card)

    # ---- 9. streaming ----
    streaming_path(torch, dev, data, wrappers, card)

    # ---- 10. LZO, the fixed step, meshes, two processes, the CLI ----
    lzo_path(torch, data, card)
    fixed_step_path(torch, dev, data, card)
    mesh_path(torch, dev, data, card)
    multiprocess_path(card)
    cli_path(data, card)

    # ---- 11. TS and sizes-only archives decoded on the card ----
    stats["decode"]["whole_member"] = index_kinds_path(torch, dev, data, card)

    # ---- 12. the captured programs against their eager functions ----
    programs = graph_checks(torch, dev, de._np_u8(data), card)

    kernels = [
        dict(name=name, route="cuda",
             source=f"decompress_tpu_torch/csrc/{src}", replaces=rep,
             launches=launches[name], **stats[name],
             launches_per_replay={label: p["launches"][name] for label, p in programs.items()
                                  if name in p["launches"]})
        for name, (src, rep) in SOURCES.items()]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
