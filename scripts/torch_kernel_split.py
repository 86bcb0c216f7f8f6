#!/usr/bin/env python3
"""Device time of the port's mark-path, literal-bits, histograms and
decode stages, split by CUDA kernel, for one checkout of
``decompress_tpu_torch``, on one card.

    python3 scripts/torch_kernel_split.py [ROOT]

ROOT (default: the checkout holding this script) is the directory whose
``decompress_tpu_torch`` package is imported and built; pointing it at an
unpacked older commit compares two versions on one card within one run
(in turns: old, new, new, old, one process each).  The inputs are
``chip_smoke.py``'s main cases: the first batch of the 8 MiB corpus (8
segments of 130,560 bytes), its level-4 jump array (P = 2^17) for the
mark path, its level-6 round-A literal cost table for the literal bits,
its level-6 round-A parse arrays for the histograms, and the split rows
of the corpus's level-6 sharded archive (65 members) for the decode.
The literal-bits stage is what round B runs for the bits and their
prefix sum: ``cost_cu.litbits_pref`` where the package has it, else the
``litbits`` kernel followed by ``zeros_like``, ``cumsum`` and ``cat``;
the decode passes ``stage``'s ``nbits`` and ``blocks`` where the package
stages them, and prints the synchronisation rounds per row where its
kernel reports them.  Prints one JSON line: the card's name and power
limit, and per stage the CUDA-event ms per call and the device ms per
call of every device kernel it launched (profiler, 50 calls), L2-warm and
with 64 MB overwritten before each call (cold).  Exits 2 without CUDA.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
ITERS = 50
FLUSH_BYTES = 64 << 20  # more than the H100's 50 MB L2


def kernel_name(name: str) -> str:
    """A device kernel's name without its namespace, return type and
    arguments where it is one of the port's (``(anonymous
    namespace)::k<10>(...)``), else its first 90 characters."""
    port = name.removeprefix("void ")
    if port.startswith("(anonymous namespace)::"):
        return port.split("::", 1)[1].split("(", 1)[0]
    return name[:90]


def profiled(torch, fn, flush=None) -> dict[str, float]:
    """Device ms per call of every device kernel fn() launches; with
    ``flush``, flush() runs before each call and its own kernels (by
    name, from a profile of flush() alone) are left out."""
    from torch.profiler import ProfilerActivity, profile

    skip = set() if flush is None else set(profiled(torch, flush))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    # the profiler may drop a few records of a long run: a kernel's time
    # per call is its mean duration times its launches per call, rounded
    durations: dict[str, list] = {}
    for e in prof.events():
        k = kernel_name(e.name)
        if e.device_type == torch.autograd.DeviceType.CUDA and k not in skip:
            durations.setdefault(k, []).append(e.time_range.elapsed_us() / 1e3)
    return {k: sum(d) / len(d) * max(1, round(len(d) / ITERS)) for k, d in durations.items()}


def measure(torch, fn) -> dict:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    stop.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(stop) / ITERS
    warm = profiled(torch, fn)
    scratch = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    cold = profiled(torch, fn, flush=lambda: scratch.fill_(1))
    return {"event_ms": event_ms, "device_ms": sum(warm.values()), "by_kernel": warm,
            "device_cold_ms": sum(cold.values()), "cold_by_kernel": cold}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_split: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    root = pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else HERE).resolve()
    sys.path.insert(0, str(root))
    import numpy as np

    from decompress_tpu_torch import _build, de
    from decompress_tpu_torch.ops import cost_cu, hist_cu, inflate_cu, lz77, parse_cu
    from decompress_tpu_torch.parallel import sharded

    if not pathlib.Path(de.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {de.__file__}, not the package under {root}")
    _build.lib()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")

    size = 8 << 20
    base = b"".join(p.read_bytes() for p in sorted((HERE / "tests" / "corpus").iterdir()))
    data = (base * -(-size // len(base)))[:size]
    arr = de._np_u8(data)
    seg = de.SEGMENT_SIZE
    payload, head, n_valid, hist_len, _ = de._build_batch_payload(
        arr, 0, de.MAX_DEVICE_BATCH, seg)
    d_data = de._assemble_batch_device(torch.from_numpy(payload).to(dev),
                                       torch.from_numpy(head).to(dev))
    nv, hl = torch.from_numpy(n_valid).to(dev), torch.from_numpy(hist_len).to(dev)

    res = lz77.lz77_analyze(d_data, nv, hl, level=4, seg_len=seg)
    take, ln = lz77._take_defer(res["cand_length"], nv, seg, lz77.LEVELS[4].lazy)
    g2 = lz77.jump_array(take, ln, seg, lz77._ceil_pow2(seg))
    res6 = lz77.lz77_analyze(d_data, nv, hl, level=6, seg_len=seg)
    lc = torch.from_numpy(lz77._cost_tables_host(
        res6["hist_lit"].cpu().numpy(), res6["hist_dist"].cpu().numpy())[0].astype("i4")).to(dev)
    lit = d_data[:, lz77.HIST:]
    hist_args = (res6["on_path"], res6["is_match"], res6["length"], res6["dist"], lit)

    archive = sharded.sharded_gzip_compress(data, 6, device="cuda")
    metas, huff, rows, max_cmds = sharded.decode_plan(np.frombuffer(archive, np.uint8))
    st = inflate_cu.stage([metas[i][1] for i in huff], [metas[i][0][1] for i in huff],
                          [metas[i][0][2] for i in huff], rows, dev)
    dec_args = (st["words"], st["tabs"], st["row_ptr"], st["start"], st["stop"])
    rounds = None
    if "nbits" in st:  # the warp-per-row kernel
        dec_args += (st["nbits"], st["blocks"])
        r = torch.empty_like(st["start"])
        inflate_cu.decode(*dec_args, max_cmds, rounds=r)
        rounds = {"mean": float(r.double().mean()), "max": int(r.max()),
                  "rows_with_none": int((r == 0).sum()), "rows": r.numel()}
    dec_args += (max_cmds,)

    if hasattr(cost_cu, "litbits_pref"):
        def prefix():
            return cost_cu.litbits_pref(lit, lc)
    else:
        def prefix():
            bits = cost_cu.litbits(lit, lc)
            return bits, torch.cat([torch.zeros_like(bits[:, :1]),
                                    torch.cumsum(bits, 1, dtype=torch.int32)], 1)

    print(json.dumps({
        "root": str(root), "card": card, "shape": list(g2.shape),
        "mark_path": measure(torch, lambda: parse_cu.mark_path(g2)),
        "litbits_and_prefix": measure(torch, prefix),
        "histograms": measure(torch, lambda: hist_cu.histograms(*hist_args)),
        "decode": measure(torch, lambda: inflate_cu.decode(*dec_args)),
        "decode_rows": int(st["start"].numel()), "decode_sync_rounds": rounds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
