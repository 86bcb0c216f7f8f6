#!/usr/bin/env python3
"""Where the probe kernel's time goes: variants of ``csrc/probe.cu``'s
``probe_kernel`` timed on the arguments round A gives it, on one card.

    python3 scripts/torch_probe_ablate.py [PARENT_ROOT]

Each variant is this checkout's ``csrc/probe.cu`` with source lines
replaced, built by ``nvcc`` into its own library under
``build/probe_ablate/`` and called through its ``dtt_probe``:

* ``kernel``: the source as it is (held equal to ``probe_plain``);
* ``no_walk``: no rank walks its predecessors (the staging of the keys
  and records, and the winners' scatter, alone);
* ``keys_only``: ``no_walk`` without the records' copies (the keys'
  staging and the scatter);
* ``no_scatter``: ``no_walk`` with the winners stored only where a
  (never met) condition holds (the keys' and records' staging);
* ``no_rungs``: the walk without the ladder's rungs above the two exact
  words (nor the reads of the fields they need);
* ``blocks8``: the kernel held to 32 registers a thread, so that 8
  blocks of 256 threads fit on an SM;
* ``parent``: PARENT_ROOT's ``csrc/probe.cu`` as it is, where a
  PARENT_ROOT is given, on the same keys and records in its layout (keys
  ``hash << pos_bits | pos``; the word ahead of a record's fields).

On ``chip_smoke.py``'s production batch (B = 8, T = 163,328) at levels
6, 4 and 12: device ms a call from a profile, L2-warm and cold (64 MB
overwritten before each call).  Prints the card's name and power limit
and one JSON line last.  Exits 2 without CUDA.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent
_NO_WALK = ("    const int kmax = min(K, li);", "    const int kmax = 0;")
#: variant -> (source line, its replacement) pairs
PATCHES = {
    "kernel": (),
    "no_walk": (_NO_WALK,),
    "keys_only": (_NO_WALK, (
        "      __pipeline_memcpy_async(s_rec + i * SV + m, rrow + static_cast<size_t>(p) * V + m, 16);",
        "      (void)rrow;")),
    "no_scatter": (_NO_WALK, (
        "  out[o] = pack_winner(best, best_cand, best_p4, p);",
        "  if (best_cand == -7) out[o] = pack_winner(best, best_cand, best_p4, p);")),
    "no_rungs": (("          grade += rung_grade<R>(x);", "          grade += 0;"),),
    "blocks8": (("__global__ void __launch_bounds__(kTile)\n    probe_kernel",
                 "__global__ void __launch_bounds__(kTile, 8)\n    probe_kernel"),),
}
LEVELS = (6, 4, 12)


def build(name: str, source: str, nvcc: str, flags) -> ctypes.CDLL:
    """``source`` compiled into build/probe_ablate/<name>/, loaded."""
    out = HERE / "build" / "probe_ablate" / name
    out.mkdir(parents=True, exist_ok=True)
    src = out / "probe.cu"
    src.write_text(source)
    lib = out / "libprobe.so"
    subprocess.run([nvcc, *flags, "-shared", "-o", str(lib), str(src)], check=True)
    handle = ctypes.CDLL(str(lib))
    handle.dtt_probe.argtypes = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)
    handle.dtt_probe.restype = ctypes.c_int
    return handle


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_probe_ablate: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    parent = pathlib.Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else None
    sys.path.insert(0, str(HERE))
    import chip_smoke
    from decompress_tpu_torch import _build, de
    from decompress_tpu_torch.ops import probe_cu

    card = chip_smoke.card_line()
    nvcc = _build._nvcc()
    source = (_build.CSRC / "probe.cu").read_text()
    libs = {}
    for name, patches in PATCHES.items():
        text = source
        for old, new in patches:
            if text.count(old) != 1:
                raise AssertionError(f"{name}: {old!r} is not in probe.cu once")
            text = text.replace(old, new)
        libs[name] = build(name, text, nvcc, _build.NVCC_FLAGS)
    if parent is not None:
        libs["parent"] = build("parent", (parent / "decompress_tpu_torch" / "csrc" /
                                          "probe.cu").read_text(), nvcc, _build.NVCC_FLAGS)

    dev = torch.device("cuda")
    arr = de._np_u8(chip_smoke.corpus_bytes())
    scratch = torch.empty(chip_smoke.FLUSH_BYTES, dtype=torch.uint8, device=dev)
    result = {"card": card, "levels": {}}
    for level in LEVELS:
        (skey, pos_bits, rec, vlo, vhi), kw = chip_smoke.round_a_calls(
            torch, dev, arr, "production", dict(level=level))["probe"]
        r = probe_cu.RECORD_WIDTH[kw["full_ladder"]]
        b, t = skey.shape
        hist = kw["hist"]
        want = probe_cu.probe_plain(skey, pos_bits, rec, vlo, vhi, **kw)

        def call(lib, key_in, rec_in):
            out = torch.empty((b, t - hist), dtype=torch.int64, device=dev)
            out2 = torch.empty_like(out) if kw["top2"] else None
            err = lib.dtt_probe(key_in.data_ptr(), rec_in.data_ptr(), vlo.data_ptr(),
                                vhi.data_ptr(), out.data_ptr(),
                                0 if out2 is None else out2.data_ptr(), b, t, hist, pos_bits,
                                kw["max_dist"], kw["k"], r, _build.stream(skey))
            if err:
                raise RuntimeError(f"dtt_probe failed with {err}")
            return out, out2

        pos, h, word = probe_cu.key_parts(skey, pos_bits)
        old_key = (h << pos_bits) | pos
        by_pos = torch.zeros_like(pos).scatter_(1, pos, word).to(torch.int32)
        old_rec = torch.cat([by_pos[..., None], rec[:, :, :r - 1]], 2).contiguous()
        row = {}
        for name, lib in libs.items():
            args = (lib, old_key, old_rec) if name == "parent" else (lib, skey, rec)
            got = call(*args)
            torch.cuda.synchronize()
            same = all(w is None or torch.equal(g, w) for g, w in zip(got, want))
            if name in ("kernel", "parent") and not same:
                raise AssertionError(f"level {level}: {name} differs from probe_plain")
            warm, _ = chip_smoke.device_split(torch, lambda: call(*args))
            cold, _ = chip_smoke.device_split(torch, lambda: call(*args),
                                              flush=lambda: scratch.fill_(1))
            row[name] = {"warm_ms": sum(warm.values()), "cold_ms": sum(cold.values())}
            print(f"probe level {level} {name:9s}: device {row[name]['warm_ms']:.4f} ms warm, "
                  f"{row[name]['cold_ms']:.4f} ms cold [{card}]", flush=True)
        result["levels"][level] = row
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
