"""The port never imports JAX: with ``jax`` made unimportable, importing
``decompress_tpu_torch`` and compressing 10 KB on the CPU at levels 4
and 6 (round B) still works
(the machine with the card has no JAX)."""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

_SCRIPT = """
import gzip, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["jaxlib"] = None
import decompress_tpu_torch
from decompress_tpu_torch import _build, gz
from decompress_tpu_torch.ops import (bitpack, codes, cost_cu, hist_cu, lz77,
                                      pack_cu, parse_cu)
x = open("tests/corpus/paper1", "rb").read()[:10_000]
out = gz.compress(x, level=4, segment_size=4096, device="cpu")
assert gzip.decompress(out) == x
out = gz.compress(x, segment_size=4096, device="cpu")  # level 6, round B
assert gzip.decompress(out) == x
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
               if sys.modules[m] is not None)
print("ok", len(out))
"""


def test_port_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok ")
