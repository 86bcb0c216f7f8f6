#!/usr/bin/env python3
"""Device time of the port's CRC kernel alone, ``crc_cu.crc32_rows``, for
one checkout of ``decompress_tpu_torch``, on one card.

    python3 scripts/torch_crc_split.py [ROOT]

ROOT (default: the checkout holding this script) is the directory whose
package is imported and built, so versions of the kernel (an older commit,
or a copy with an edited ``csrc/crc.cu``) can be compared on one card
within one run, one process each.  The input is what the sharded decode
passes the CRC: the 8 MiB corpus of ``chip_smoke.py`` as 65 members of
130,560 bytes, in rows of 131,072 bytes zeroed past each length, with the
lengths as int32 on the card.  The kernel is timed at the block size the
package picks and at each of 1, 2, 4 and 8 sub-spans a block.  Prints one
JSON line: the card's name and power limit, and per block size the
CUDA-event ms per call and the device ms per call of every device kernel
(profiler, 50 calls), L2-warm and with 64 MB overwritten before each call
(cold).  Exits 2 without CUDA.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

from torch_kernel_split import HERE, measure


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_crc_split: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    root = pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else HERE).resolve()
    sys.path.insert(0, str(root))
    from decompress_tpu_torch import _build
    from decompress_tpu_torch.ops import crc_cu

    if not pathlib.Path(crc_cu.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {crc_cu.__file__}, not the package under {root}")
    _build.lib()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]

    size, seg, width = 8 << 20, 130_560, 1 << 17
    base = b"".join(p.read_bytes() for p in sorted((HERE / "tests" / "corpus").iterdir()))
    arr = np.frombuffer((base * -(-size // len(base)))[:size], np.uint8)
    m = -(-size // seg)
    rows = np.zeros((m, width), np.uint8)
    lengths = np.zeros(m, np.int32)
    for k in range(m):
        part = arr[k * seg:(k + 1) * seg]
        rows[k, :part.size], lengths[k] = part, part.size
    args = (torch.from_numpy(rows).to("cuda"), torch.from_numpy(lengths).to("cuda"))

    spans = crc_cu._spans
    out = {"root": str(root), "card": card, "rows": m, "width": width,
           "block_size": spans(m, width),
           "default": measure(torch, lambda: crc_cu.crc32_rows(*args))}
    for k in (1, 2, 4, 8):
        crc_cu._spans = lambda m_, w_, k=k: k
        out[f"spans_{k}"] = measure(torch, lambda: crc_cu.crc32_rows(*args))
    crc_cu._spans = spans
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
