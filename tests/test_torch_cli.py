"""The port's command line (``python -m decompress_tpu_torch.cli``) against
the reference's library functions: each format compressed through
``cli.main([..., "--device", "cpu"])`` writes the bytes the reference's
function writes, and decompresses the reference's streams; one run in a
subprocess filters stdin to stdout; garbage exits 1 with the reference
CLI's message; without a card and without ``--device cpu`` it exits 1
with the device message in either direction, reading no environment
variable for the device.
"""

import gzip
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from decompress_tpu import cli as ref_cli
from decompress_tpu import de as ref_de
from decompress_tpu import gz as ref_gz
from decompress_tpu import lzo as ref_lzo
from decompress_tpu import zl as ref_zl
from decompress_tpu_torch import cli
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = (ROOT / "tests" / "corpus" / "progc").read_bytes()[:20000]


def _reference(fmt, level, path):
    if fmt == "deflate":
        return ref_de.deflate(DATA, level)
    if fmt == "zlib":
        return ref_zl.deflate(DATA, level)
    if fmt == "gzip":
        return ref_gz.compress(DATA, level, mtime=7, filename=path)
    return ref_lzo.compress(DATA, level=max(level, 1))


_DECODE = {"deflate": ref_de.inflate, "zlib": ref_zl.inflate, "gzip": ref_gz.decompress,
           "lzo": ref_lzo.uncompress}


@pytest.mark.parametrize("fmt,level", [("deflate", 6), ("zlib", 6), ("zlib", 0),
                                       ("gzip", 4), ("lzo", 6)])
def test_cli_both_directions_match_reference(tmp_path, fmt, level):
    src, comp, back = tmp_path / "in.bin", tmp_path / "out.bin", tmp_path / "back.bin"
    src.write_bytes(DATA)
    assert cli.main(["-f", fmt, "-l", str(level), "--mtime", "7", "--device", "cpu",
                     str(src), str(comp)]) == 0
    want = _reference(fmt, level, str(src))
    assert comp.read_bytes() == want
    assert _DECODE[fmt](want) == DATA
    comp.write_bytes(want)
    assert cli.main(["-d", "-f", fmt, "--device", "cpu", str(comp), str(back)]) == 0
    assert back.read_bytes() == DATA


def test_cli_subprocess_filters_stdin_to_stdout():
    # one intra-op thread, as tests/torch_threads.py gives the test processes
    env = dict(os.environ, OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-m", "decompress_tpu_torch.cli", "-f", "gzip",
                        "--device", "cpu"], input=DATA, capture_output=True, cwd=ROOT,
                       env=env, timeout=120)
    assert p.returncode == 0, p.stderr.decode()
    assert p.stdout == ref_gz.compress(DATA, 6)
    assert gzip.decompress(p.stdout) == DATA


def test_cli_garbage_exits_1_with_the_message(capsys, monkeypatch):
    for fmt in ("zlib", "gzip", "lzo", "deflate"):
        monkeypatch.setattr(sys, "stdin", _Stdin(b"not a compressed stream"))
        assert ref_cli.main(["-d", "-f", fmt]) == 1
        want = capsys.readouterr().err
        monkeypatch.setattr(sys, "stdin", _Stdin(b"not a compressed stream"))
        assert cli.main(["-d", "-f", fmt, "--device", "cpu"]) == 1
        got = capsys.readouterr()
        assert got.err == want and got.err.startswith("decompress: ") and got.out == ""


def test_cli_without_a_card(capsys, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("DECOMPRESS_TPU_PLATFORM", "cpu")  # the reference's override
    src = tmp_path / "in.bin"
    src.write_bytes(DATA)
    for direction in ([], ["-d"]):
        assert cli.main([*direction, "-f", "zlib", str(src), str(tmp_path / "out.bin")]) == 1
        err = capsys.readouterr().err
        assert err.startswith("decompress: device='cuda'") and "is_available() is False" in err
        assert not (tmp_path / "out.bin").exists()
    with pytest.raises(SystemExit) as e:
        cli.main(["-l", "13", "--device", "cpu"])
    assert e.value.code == 2


class _Stdin:
    """A stdin whose ``buffer`` reads the given bytes."""

    def __init__(self, data: bytes):
        import io

        self.buffer = io.BytesIO(data)
