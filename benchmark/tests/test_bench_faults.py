"""The check that decides ``correct``, shown to fail: a run of each cell
on the CPU at a small size, with the timed path broken underneath (the
program's entry point replaced by a stand-in with a fault), comes out
not correct for each fault the cell can have; with a sound stand-in and
with the program itself it comes out correct.  The control (the
reference in the program's place with one guarantee broken,
``benchmark/control.py``) comes out not correct too."""

import io
import json
import time

import numpy as np
import pytest

from benchmark import control, harness, reference, spec

CELLS = ("gz6-calgary-8m-x1", "archive6-calgary-16m-write-x1", "archive6-calgary-16m-read-x1")
SMALL = {"input_bytes": 100_000, "inputs": 2}
MEMBER = 40_000


def small_cell(name):
    cell = spec.load_cell(name)
    cell["traffic"] = dict(cell["traffic"], **SMALL)
    if "member_size" in cell["config"]:
        cell["config"] = dict(cell["config"], member_size=MEMBER)
    return cell


def run_cell(cell, entry=None, trace=False):
    out = io.StringIO()
    rc = harness.run(cell, 424242, 0.3, trace, t_start=time.perf_counter(), device="cpu",
                     entry=entry, out=out, err=io.StringIO())
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _flip(b: bytes) -> bytes:
    x = bytearray(b)
    x[len(x) // 2] ^= 0x10
    return bytes(x)


def _u8(data):
    return np.frombuffer(bytes(memoryview(np.ascontiguousarray(data)).cast("B")), np.uint8)


def sound_gzip(cfg):
    return lambda data, level=6, **kw: control.gzip_member(data, level, cfg["header"])


def sound_archive(cfg):
    def write(data, level=6, *, member_size, **kw):
        return control.archive(data, level, member_size, cfg["header"], cfg["index"])
    return write


def sound_decode(archive_bytes, **kw):
    out, pos = [], 0
    while pos < len(archive_bytes):
        _, body = reference.parse_header(archive_bytes, pos)
        decoded, end = reference.inflate_member(archive_bytes, body)
        out.append(decoded)
        pos = end + 8
    return b"".join(out)


#: each fault applied to a sound call: (fault name, broken call from sound call)
COMPRESS_FAULTS = {
    "unchanged": lambda sound: lambda data, *a, **k: bytes(_u8(data)),
    "half": lambda sound: lambda data, *a, **k: sound(_u8(data)[: _u8(data).size // 2], *a, **k),
    "altered": lambda sound: lambda data, *a, **k: _flip(sound(data, *a, **k)),
}
DECODE_FAULTS = {
    "unchanged": lambda sound: lambda arch, **k: bytes(arch),
    "half": lambda sound: lambda arch, **k: sound(arch)[: len(sound(arch)) // 2],
    "altered": lambda sound: lambda arch, **k: _flip(sound(arch)),
}


def _patch(monkeypatch, name, fn):
    from decompress_tpu_torch import gz
    from decompress_tpu_torch.parallel import sharded

    cfg = spec.load_cell(name)["config"]
    if cfg["entry"] == "gzip_oneshot":
        monkeypatch.setattr(gz, "compress", fn(sound_gzip(cfg)))
    elif spec.load_cell(name)["traffic"]["call"] == "compress":
        monkeypatch.setattr(sharded, "sharded_gzip_compress", fn(sound_archive(cfg)))
    else:
        # the archives are the program's, written in set-up; the decode is broken
        monkeypatch.setattr(sharded, "sharded_gzip_decompress", fn(sound_decode))


def _faults(name):
    return DECODE_FAULTS if "read" in name else COMPRESS_FAULTS


@pytest.mark.parametrize("name", CELLS)
def test_sound_stand_in_is_correct(monkeypatch, name):
    _patch(monkeypatch, name, lambda sound: sound)
    assert run_cell(small_cell(name))["correct"] is True


@pytest.mark.parametrize("name,fault", [(n, f) for n in CELLS for f in COMPRESS_FAULTS])
def test_fault_is_not_correct(monkeypatch, name, fault):
    _patch(monkeypatch, name, _faults(name)[fault])
    res = run_cell(small_cell(name))
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_the_program_is_correct(name):
    res = run_cell(small_cell(name))
    assert res["correct"] is True
    assert res["device"]["platform"] == "cpu"


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = small_cell(name)
    entry = control.control_entry(cell["config"], cell["traffic"], "cpu")
    res = run_cell(cell, entry=entry)
    assert res["correct"] is False


def test_split_fault_is_caught_where_walked():
    cfg = small_cell(CELLS[1])["config"]
    from benchmark import inputs

    x = inputs.make_input(inputs.load_corpus("calgary"), 200_000, 5, 0)
    good = control.archive(x, 6, MEMBER, cfg["header"], cfg["index"])
    bad = control.archive(x, 6, MEMBER, cfg["header"], cfg["index"], splits_at_stride=True)
    walk = set(range(-(-x.size // MEMBER)))
    assert reference.check_archive(good, x, MEMBER, cfg["header"], cfg["index"], walk) == \
        {"members": 0, "index": 0, "splits": 0}
    assert reference.check_archive(bad, x, MEMBER, cfg["header"], cfg["index"], walk)["splits"] > 0
