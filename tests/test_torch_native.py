"""The port's copy of the native host runtime (``decompress_tpu_torch/native``).

``tpuz.cpp`` must stay the reference's byte for byte.  Each library
(libtpuz, and libplan of the port's own ``plan.cpp``) builds atomically:
six processes started together, all building into one fresh directory,
each load a whole library and call it; five processes started while a
slowed compiler has written half of its output wait for the whole
library (no process loads a half-written file); and a source that does
not compile raises with the compiler's message.  Each entry point is held to an independent oracle: the
checksums and their combines to ``zlib`` and to the port's own
``ops.checksum`` combines; the LZO codec to the reference's pure-Python
LZO decoder; the streaming inflater (chunked input and output, ``clone``,
``set_dictionary``, ``set_window_bits``, ``takeback``) to ``zlib``; the
command expansion to its definition.  The reference's own native library
is never loaded here.
"""

import hashlib
import os
import pathlib
import subprocess
import sys
import time
import zlib

import numpy as np
import pytest

from decompress_tpu import lzo as ref_lzo
from decompress_tpu_torch import native
from decompress_tpu_torch.ops import checksum

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [rng.integers(97, 123, rng.integers(2, 9), np.uint8).tobytes()
             for _ in range(300)]
    return b" ".join(words[i] for i in rng.integers(0, len(words), n // 3))[:n]


def test_source_is_the_reference_copy():
    ref = (ROOT / "decompress_tpu" / "native" / "tpuz.cpp").read_bytes()
    ours = native.SRC.read_bytes()
    assert hashlib.sha256(ours).hexdigest() == hashlib.sha256(ref).hexdigest()


_BUILD_AND_LOAD = """
import pathlib, sys, zlib
import numpy as np
from decompress_tpu_torch import native
native.BUILD_DIR = pathlib.Path(sys.argv[1])
src = native.SRC.parent / sys.argv[2]
if src == native.SRC:
    assert native.adler32(b"abc" * 1000) == zlib.adler32(b"abc" * 1000)
else:  # an empty final block: fixed (10 bits) beats stored (40)
    outs = [np.zeros((1, w), dt) for w, dt in zip((1024, 1024, 286, 286, 30, 30, 1, 1),
                                                   (np.uint32, np.int32) * 4)]
    kinds, _ = native.plan_blocks(np.zeros((1, 286), np.int32), np.zeros((1, 30), np.int32),
                                  [0], [1], outs)
    assert kinds.tolist() == [1] and outs[1][0, :3].tolist() == [1, 2, 0]
print(native.build(src))
"""


@pytest.mark.parametrize("source", ["tpuz.cpp", "plan.cpp"])
def test_concurrent_builds_all_load(tmp_path, source):
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_LOAD, str(tmp_path), source],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    results = [p.communicate(timeout=300) + (p.returncode,) for p in procs]
    assert [rc for *_, rc in results] == [0] * 6, [err for _, err, _ in results]
    paths = {out.strip() for out, _, _ in results}
    assert len(paths) == 1
    lib = pathlib.Path(paths.pop())
    name = native.lib_name(native.SRC.parent / source)
    assert lib.parent.parent == tmp_path and lib.name == name
    assert sorted(p.name for p in lib.parent.iterdir()) == [".lock", name]


_SLOW_GXX = """#!{python}
# g++ that compiles, then writes its output in two halves a while apart
import os, subprocess, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
args[args.index("-o") + 1] = out + ".whole"
rc = subprocess.run([{real!r}, *args]).returncode
if rc:
    sys.exit(rc)
data = open(out + ".whole", "rb").read()
os.unlink(out + ".whole")
with open(out, "wb") as f:
    f.write(data[: len(data) // 2])
    f.flush()
    time.sleep(3)
    f.write(data[len(data) // 2 :])
"""


def test_half_written_build_is_never_loaded(tmp_path):
    """One process builds with a compiler that leaves its output half
    written for 3 s; five more start as soon as any output file appears.
    Each must wait for the whole library and load it."""
    import shutil

    bindir = tmp_path / "bin"
    bindir.mkdir()
    gxx = bindir / "g++"
    gxx.write_text(_SLOW_GXX.format(python=sys.executable, real=shutil.which("g++")))
    gxx.chmod(0o755)
    env = dict(os.environ, PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}")
    build = tmp_path / "build"

    def start():
        return subprocess.Popen([sys.executable, "-c", _BUILD_AND_LOAD, str(build),
                                 "tpuz.cpp"],
                                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    first = start()
    deadline = time.monotonic() + 120
    while not any(p.name.startswith(native.lib_name(native.SRC)) for p in build.rglob("*")):
        assert time.monotonic() < deadline and first.poll() is None, first.communicate()
        time.sleep(0.02)
    procs = [first] + [start() for _ in range(5)]
    results = [p.communicate(timeout=300) + (p.returncode,) for p in procs]
    assert [rc for *_, rc in results] == [0] * 6, [err for _, err, _ in results]


def test_failed_build_raises_with_compiler_message(tmp_path, monkeypatch):
    bad = tmp_path / "tpuz.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as ei:
        native.build()
    assert "error" in str(ei.value)
    assert not any((tmp_path / "build").rglob("*.so"))


@pytest.mark.parametrize("n", [0, 1, 255, 5552, 5553, 100_003])
def test_checksums_match_zlib(n):
    x = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    for data in (x, x.tobytes(), b"\xff" * n):
        assert native.adler32(data) == zlib.adler32(bytes(data))
        assert native.adler32(data, 0xDEADBEEF) == zlib.adler32(bytes(data), 0xDEADBEEF)
        assert native.crc32(data) == zlib.crc32(bytes(data))
        assert native.crc32(data, 0xDEADBEEF) == zlib.crc32(bytes(data), 0xDEADBEEF)


@pytest.mark.parametrize("split", [0, 1, 700, 6000])
def test_combines_match_zlib_and_port(split):
    x = _text(6000, 1)
    a, b = x[:split], x[split:]
    args = (zlib.adler32(a), zlib.adler32(b), len(b))
    assert native.adler32_combine(*args) == zlib.adler32(x) == checksum.adler32_combine(*args)
    args = (zlib.crc32(a), zlib.crc32(b), len(b))
    assert native.crc32_combine(*args) == zlib.crc32(x) == checksum.crc32_combine(*args)


@pytest.mark.parametrize("data", [b"", b"a", _text(40_000, 2),
                                  np.random.default_rng(3).integers(0, 256, 3000,
                                                                    np.uint8).tobytes(),
                                  bytes(20_000)], ids=["empty", "one", "text", "random",
                                                       "zeros"])
def test_lzo_round_trip_and_reference_decoder(data):
    comp = native.lzo1x_compress(data)
    assert native.lzo1x_decompress(comp, len(data)) == data
    assert ref_lzo._uncompress_python(comp) == data
    if data:
        with pytest.raises(native.LzoNativeError):
            native.lzo1x_decompress(comp, len(data) - 1)


def _raw(data: bytes, level: int = 6, zdict: bytes | None = None) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 9, 0, *((zdict,) if zdict else ()))
    return c.compress(data) + c.flush()


def _drain(inf, src: bytes, piece: int, cap: int):
    """Feed ``src`` in pieces with ``cap``-byte output windows; returns
    (status, output, bytes consumed)."""
    out, pos = bytearray(), 0
    while True:
        status, used, produced = inf.run(src[pos:pos + piece], cap)
        pos += used
        out += produced
        if status in (native.InflateStream.END, native.InflateStream.MALFORMED):
            return status, bytes(out), pos
        if status == native.InflateStream.AWAIT and pos >= len(src):
            return status, bytes(out), pos


def test_inflate_stream_chunked_and_takeback():
    x = _text(60_000, 4)
    stream = _raw(x) + b"NEXT"
    inf = native.InflateStream()
    status, out, used = _drain(inf, stream, 1000, 777)
    assert (status, out) == (native.InflateStream.END, x)
    assert used - len(inf.takeback()) == len(stream) - 4
    assert inf.total_out == len(x)
    inf.reset()
    status, out, _ = _drain(inf, stream, len(stream), 1 << 20)
    assert (status, out) == (native.InflateStream.END, x)


def test_inflate_stream_clone_resumes_independently():
    x = _text(50_000, 5)
    stream = _raw(x)
    inf = native.InflateStream()
    status, used, first = inf.run(stream[: len(stream) // 2], 1 << 20)
    assert status == native.InflateStream.AWAIT
    twin = inf.clone()
    rest = [_drain(s, stream[used:], 999, 4096) for s in (inf, twin)]
    assert rest[0] == rest[1]
    assert first + rest[0][1] == x


def test_inflate_stream_dictionary_and_window_bits():
    zdict = _text(3000, 6)
    x = _text(20_000, 7)
    inf = native.InflateStream()
    inf.set_dictionary(zdict)
    assert _drain(inf, _raw(x, zdict=zdict), 4096, 1 << 16)[:2] == (
        native.InflateStream.END, x)
    inf = native.InflateStream()
    inf.set_window_bits(9)
    status, _, _ = _drain(inf, _raw(x), 4096, 1 << 16)
    assert status == native.InflateStream.MALFORMED
    assert inf.error == "invalid distance"


def test_expand_cmds():
    # "ab", then a copy of 5 at distance 2, then the end
    cmds = np.array([ord("a"), ord("b"), (1 << 26) | (2 << 10) | 5, 2 << 26, ord("z")],
                    np.uint32)
    out = np.zeros(16, np.uint8)
    assert native.expand_cmds(cmds, out) == 7
    assert out[:7].tobytes() == b"abababa"
    with pytest.raises(ValueError):
        native.expand_cmds(np.array([(1 << 26) | (3 << 10) | 4], np.uint32), out)
    with pytest.raises(TypeError):
        native.expand_cmds(cmds.astype(np.int64), out)


def test_buffers_are_checked_before_native_calls():
    inf = native.InflateStream()
    stream = _raw(b"abc" * 100)
    with pytest.raises(TypeError):
        inf.run_into(stream, np.zeros(400, np.int32), 0)
    with pytest.raises(ValueError):
        inf.run_into(stream, np.zeros(400, np.uint8), 401)
    with pytest.raises(TypeError):
        inf.run_into(stream, np.zeros(800, np.uint8)[::2], 0)
    out = np.zeros(400, np.uint8)
    assert inf.run_into(stream, out, 50) == (native.InflateStream.END, len(stream), 300)
    assert out[50:350].tobytes() == b"abc" * 100
