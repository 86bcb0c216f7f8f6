"""The port never imports JAX or the reference package: with ``jax`` and
``decompress_tpu`` made unimportable, importing ``decompress_tpu_torch``,
compressing 10 KB on the CPU at levels 4 and 6 (round B) and in five
batches (the pipelined schedule), a sharded archive's round trip and one
of three chunks (the windowed schedule) decoded on both ``expand``
routes, zlib framing (one-shot and sharded), the host
decode through the native library, Adler-32, the streaming codecs
(``streaming``, ``lz``, the streaming ``zl`` / ``gz`` classes, both
engines), LZO, the fixed-Huffman step (``ops.pipeline``) alone and over a
mesh, a mesh archive, the single-process multi-process writer
(``parallel.multihost``), ``utils`` (``CodecConfig``, profiling) and the
CLI still work (the machine with the card has no JAX);
and no source file of the port, nor ``chip_smoke.py``, has an import line
of the reference package."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

_SCRIPT = """
import gzip, os, sys, tempfile, zlib
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["jaxlib"] = None
sys.modules["decompress_tpu"] = None  # nor the reference package
import torch
torch.set_num_threads(1)  # beside other test workers, more threads only wait
import decompress_tpu_torch
from decompress_tpu_torch import _build, cli, de, gz, lz, lzo, native, streaming, zl
from decompress_tpu_torch.ops import (bitpack, checksum, codes, cost_cu, crc_cu,
                                      hist_cu, inflate, inflate_cu, lz77,
                                      pack_cu, parse_cu, pipeline, transfer)
from decompress_tpu_torch.parallel import multihost, sharded
from decompress_tpu_torch.utils import config, profiling
x = open("tests/corpus/paper1", "rb").read()[:10_000]
out = gz.compress(x, level=4, segment_size=4096, device="cpu")
assert gzip.decompress(out) == x
out = gz.compress(x, segment_size=4096, device="cpu")  # level 6, round B
assert gzip.decompress(out) == x
arch = sharded.sharded_gzip_compress(x, member_size=4096, device="cpu")
assert gzip.decompress(arch) == x
assert sharded.sharded_gzip_decompress(arch, device="cpu") == x
# five batches of 256-byte segments: the pipelined schedule past its depth
assert zlib.decompress(de.deflate(x, 1, segment_size=256, device="cpu"), -15) == x
# three chunks of 512-byte members: the windowed schedule; both decode routes
small = sharded.sharded_gzip_compress(x, member_size=512, device="cpu")
assert gzip.decompress(small) == x
for expand in ("auto", "device"):
    assert sharded.sharded_gzip_decompress(small, expand=expand, device="cpu") == x
assert not sharded.serial_fallbacks
assert gz.decompress(out) == x and de.inflate(out[10:-8]) == x
z = zl.deflate(x, segment_size=4096, device="cpu")
assert zl.inflate(z) == x and zlib.decompress(z) == x
z = sharded.sharded_zlib_compress(x, member_size=4096, device="cpu")
assert zl.inflate(z) == x and zlib.decompress(z) == x
assert checksum.adler32(x, device="cpu") == zlib.adler32(x) == native.adler32(x)
enc = gz.Def(6, segment_size=4096, filename="n", device="cpu")
s = enc.push(x[:7000]) + enc.push(x[7000:]) + enc.finish()
assert gzip.decompress(s) == x
parts = []
gz.higher_uncompress(iter([s[:999], s[999:], b""]).__next__, parts.append, 777)
assert b"".join(parts) == x
enc = zl.Def(4, engine="queue", device="cpu")
s = enc.push(x) + enc.finish()
dec = zl.Inf(1000)
dec.src(s)
dec.src(b"")
parts = []
while (tok := dec.decode()) == "flush":
    parts.append(dec.flush())
assert tok == "end" and b"".join(parts) + dec.flush() == x == zlib.decompress(s)
parts = []
streaming.higher_uncompress(iter([de.deflate(x, 1, device="cpu"), b""]).__next__,
                            parts.append)
assert b"".join(parts) == x
q = lz.Queue(1 << 14)
lz.compress_into(q, x[:3000])
assert de.reconstruct(q.as_array().tolist()) == x[:3000]
c = lzo.compress(x, device="cpu")
assert lzo.uncompress(c) == x == lzo.uncompress_with_buffer(c)
rows = torch.zeros((2, lz77.HIST + 1024), dtype=torch.uint8)
rows[:, lz77.HIST:] = torch.frombuffer(bytearray(x[:2048]), dtype=torch.uint8).view(2, 1024)
nv, zero, one = (torch.full((2,), v, dtype=torch.int32) for v in (1024, 0, 1))
with profiling.span("fixed step"):
    words, bits = pipeline.fixed_deflate_segments(rows, nv, zero, one, seg_len=1024)
for i in range(2):
    assert zlib.decompress(bitpack.words_to_bytes(words[i], int(bits[i])), -15) == \
        x[1024 * i:1024 * (i + 1)]
mesh = sharded.make_mesh(2, device="cpu")
w2, sizes, total = sharded.compress_step_sharded(mesh, rows, nv, zero, one, seg_len=1024)
assert torch.equal(w2, words) and int(total) == int(bits.sum())
assert sharded.sharded_gzip_compress(x, member_size=4096, mesh=mesh) == arch
assert multihost.sharded_gzip_compress_multihost(x, member_size=4096, device="cpu") == arch
cfg = config.CodecConfig(segment_size=4096, device="cpu").validate()
assert de.deflate(x, config=cfg) == de.deflate(x, segment_size=4096, device="cpu")
assert decompress_tpu_torch.rfc1951 is de
with tempfile.TemporaryDirectory() as tmp:
    src, dst = os.path.join(tmp, "in"), os.path.join(tmp, "out")
    open(src, "wb").write(x)
    assert cli.main(["-f", "gzip", "--device", "cpu", src, dst]) == 0
    assert gzip.decompress(open(dst, "rb").read()) == x
assert not any(m.split(".")[0] in ("jax", "decompress_tpu") for m in sys.modules
               if sys.modules[m] is not None)
print("ok", len(out))
"""


def test_port_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok ")


_REFERENCE_IMPORT = re.compile(r"^\s*(import|from)\s+decompress_tpu(\.|\s|$)", re.M)


def test_no_reference_import_lines():
    files = sorted((ROOT / "decompress_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    names = {str(p.relative_to(ROOT / "decompress_tpu_torch")) for p in files[:-1]}
    assert {"lzo.py", "cli.py", "ops/pipeline.py", "ops/transfer.py",
            "parallel/multihost.py", "utils/config.py", "utils/profiling.py"} <= names
    offenders = [str(p.relative_to(ROOT)) for p in files
                 if _REFERENCE_IMPORT.search(p.read_text())]
    assert offenders == []
    assert _REFERENCE_IMPORT.search("from decompress_tpu.core import tables\n")
    assert not _REFERENCE_IMPORT.search("from decompress_tpu_torch import gz\n")
