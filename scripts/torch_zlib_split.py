#!/usr/bin/env python3
"""Walls of the port's zlib slice on one card, as medians of interleaved runs.

    python3 scripts/torch_zlib_split.py [RUNS]

On the 8 MiB corpus of ``chip_smoke.py`` (level 6, ``SEGMENT_SIZE``
130,560), RUNS (default 5) rounds, each running in turn:
``gz.compress`` and ``zl.deflate`` (the same DEFLATE body, two framings),
``sharded_gzip_compress`` and ``sharded_zlib_compress`` (the latter with
its stages timed: member compression, the Adler-32 on the card, the
assembly), then the host decodes ``gz.decompress``, ``zl.inflate`` of
both zlib streams and ``de.inflate`` of the raw body, with stdlib
``zlib.decompress`` beside them as the same host's yardstick, and the
host checksums of the corpus (the native library's Adler-32 and CRC-32,
``zlib.adler32``).  Each wall is a host clock around the call with the
card synchronized on both sides.  Then Adler-32 on the card
(``ops.checksum.adler32`` of the corpus already on the card): CUDA-event
ms, device ms of every kernel and copy L2-warm and cold, and device ms by
kernel name.  Prints the card's name and power limit beside every line,
and one JSON line last.  Exits 2 without CUDA.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import sys
import time
import zlib

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_zlib_split: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from decompress_tpu_torch import de, gz, zl
    from decompress_tpu_torch import native
    from decompress_tpu_torch.ops import checksum
    from decompress_tpu_torch.parallel import sharded

    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    card = chip_smoke.card_line()
    data = chip_smoke.corpus_bytes()

    def wall(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t)

    stages = {"members (_compress_members)": (sharded, "_compress_members"),
              "Adler-32 on the card (checksum.adler32)": (checksum, "adler32")}
    spent = dict.fromkeys(stages, 0.0)
    originals = {label: getattr(mod, attr) for label, (mod, attr) in stages.items()}

    def timer(label, fn):
        def wrapper(*args, **kw):
            out, ms = wall(lambda: fn(*args, **kw))
            spent[label] += ms
            return out
        return wrapper

    def sharded_zlib_staged():
        for label, (mod, attr) in stages.items():
            spent[label] = 0.0
            setattr(mod, attr, timer(label, originals[label]))
        try:
            return sharded.sharded_zlib_compress(data, 6, device="cuda")
        finally:
            for label, (mod, attr) in stages.items():
                setattr(mod, attr, originals[label])

    compress = {
        "gz.compress": lambda: gz.compress(data, device="cuda"),
        "zl.deflate": lambda: zl.deflate(data, device="cuda"),
        "sharded_gzip_compress": lambda: sharded.sharded_gzip_compress(data, 6, device="cuda"),
        "sharded_zlib_compress": sharded_zlib_staged,
    }
    outs = {name: fn() for name, fn in compress.items()}  # warm-up
    walls = {name: [] for name in compress}
    stage_walls = {label: [] for label in stages}
    for _ in range(runs):
        for name, fn in compress.items():
            _, ms = wall(fn)
            walls[name].append(ms)
        for label in stages:
            stage_walls[label].append(spent[label])
    for name, ms in list(walls.items()) + [(f"sharded_zlib_compress stage: {k}", v)
                                           for k, v in stage_walls.items()]:
        print(f"{name}: median {statistics.median(ms):.1f} ms of {runs} runs "
              f"({min(ms):.1f}-{max(ms):.1f}) [{card}]", flush=True)

    body = outs["gz.compress"][10:-8]
    decode = {
        "gz.decompress": lambda: gz.decompress(outs["gz.compress"]),
        "zl.inflate (zl.deflate's stream)": lambda: zl.inflate(outs["zl.deflate"]),
        "zl.inflate (sharded stream)": lambda: zl.inflate(outs["sharded_zlib_compress"]),
        "de.inflate (raw body)": lambda: de.inflate(body),
        "stdlib zlib.decompress (zl.deflate's stream)":
            lambda: zlib.decompress(outs["zl.deflate"]),
        "native adler32 (host)": lambda: native.adler32(data),
        "native crc32 (host)": lambda: native.crc32(data),
        "stdlib zlib.adler32 (host)": lambda: zlib.adler32(data),
    }
    for name, fn in decode.items():
        out = fn()
        if name.startswith(("gz.", "zl.", "de.", "stdlib zlib.decompress")) and out != data:
            raise AssertionError(f"{name} does not restore the corpus")
    dwalls = {name: [] for name in decode}
    for _ in range(runs):
        for name, fn in decode.items():
            dwalls[name].append(wall(fn)[1])
    for name, ms in dwalls.items():
        print(f"{name}: median {statistics.median(ms):.2f} ms of {runs} runs "
              f"({min(ms):.2f}-{max(ms):.2f}) = "
              f"{len(data) / statistics.median(ms) / 1e3:.1f} MB/s [{card}]", flush=True)

    d_data = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to("cuda")
    if checksum.adler32(d_data) != zlib.adler32(data):
        raise AssertionError("adler32 on the card differs from zlib.adler32")
    event_ms = chip_smoke.time_ms(torch, lambda: checksum.adler32(d_data))
    scratch = torch.empty(chip_smoke.FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    warm = chip_smoke.device_total(torch, lambda: checksum.adler32(d_data))
    cold = chip_smoke.device_total(torch, lambda: checksum.adler32(d_data),
                                   flush=lambda: scratch.fill_(1))
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(chip_smoke.TIMING_ITERS):
            checksum.adler32(d_data)
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / chip_smoke.TIMING_ITERS
    bound = 1e3 * (d_data.nbytes + 8) / chip_smoke.HBM_BYTES_PER_S
    print(f"adler32 on the card: {event_ms:.4f} ms CUDA events, device {warm:.4f} ms "
          f"L2-warm, {cold:.4f} ms cold (every kernel and copy), bound {bound:.4f} ms "
          f"[{card}]", flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1]):
        print(f"  device {ms:8.4f} ms  {name[:110]}")
    print(card)
    print(json.dumps({
        "card": card, "runs": runs,
        "compress_ms": walls, "sharded_zlib_stage_ms": stage_walls,
        "decode_ms": dwalls,
        "adler32": {"event_ms": event_ms, "device_ms": warm, "device_cold_ms": cold,
                    "bound_ms": bound, "device_ms_by_kernel": by_name}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
