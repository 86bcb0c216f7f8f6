"""The per-file gzip cell (``gz6-calgary-files-x1``, entry
``gzip_files``): set-up finds the corpus's files in every input, the
batches follow the files, a sound stand-in comes out correct, and each
planted fault and the control (zlib members with every CRC-32 left at 0)
come out not correct.  The batch counter's metrics read the program's
``de.BATCH_COUNTS`` over a traced CPU window, and nothing from a program
without it."""

import io
import json
import time

import numpy as np
import pytest

from benchmark import batch_counts, control, harness, inputs, spec

CELL = "gz6-calgary-files-x1"
#: a cut corpus for runs of the program on the CPU, read at a 4,096-byte
#: segment: 1, 2, 3, 1 and 1 segments, rows 1, 2, 4, 1 and 1
CUT = (900, 5000, 9000, 3000, 4096)
SMALL_SEGMENT = 4096


@pytest.fixture(scope="module")
def cell():
    return spec.load_cell(CELL)


@pytest.fixture
def entry(cell):
    return spec.load_module("entries", "gzip_files").make(cell["config"], cell["traffic"], "cpu")


@pytest.fixture
def cut(monkeypatch, cell):
    """The cell on a corpus of the first files' prefixes (``CUT`` bytes),
    one pass an input."""
    files = [f[:n] for f, n in zip(inputs.load_corpus("calgary"), CUT)]
    monkeypatch.setattr(inputs, "load_corpus", lambda name: files)
    return dict(cell, traffic=dict(cell["traffic"], input_bytes=sum(CUT)))


def run_cell(cell, entry=None, trace=False):
    out = io.StringIO()
    rc = harness.run(cell, 2500000123, 0.3, trace, t_start=time.perf_counter(), device="cpu",
                     entry=entry, out=out, err=io.StringIO())
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("seed", [3, 2147483659, (1 << 33) + 25])
def test_every_input_holds_the_14_files_whole(cell, entry, seed):
    files = inputs.load_corpus("calgary")
    want = sorted(f.tobytes() for f in files)
    size = cell["traffic"]["input_bytes"]
    for x in inputs.make_inputs("calgary", size, seed, cell["traffic"]["inputs"]):
        payload = entry.prepare(x)
        assert len(payload) == size == x.size
        assert len(payload.parts) == 14
        assert sorted(p.tobytes() for p in payload.parts) == want
        assert np.array_equal(np.concatenate(payload.parts), x)


def test_not_whole_files_are_refused(entry):
    x = inputs.make_input(inputs.load_corpus("calgary"), 3_141_622, 5, 0)
    with pytest.raises(ValueError, match="one copy"):
        entry.prepare(x[:-1])
    with pytest.raises(ValueError, match="no whole file"):
        entry.prepare(np.roll(x, 1))


def test_batches_are_one_a_file(cell, entry):
    got = entry.batches(cell["traffic"]["input_bytes"])
    assert len(got) == 14
    assert sum(rows for rows, _, _ in got) == 29
    assert sorted(rows for rows, _, _ in got) == [1] * 9 + [2, 3, 4, 5, 6]
    assert {(row, seg) for _, row, seg in got} == {(32_768 + 130_560, 130_560)}
    with pytest.raises(ValueError, match="one copy"):
        entry.batches(2 * 3_141_622)


class Planted:
    """The cell's entry with its call replaced: zlib members, one a file,
    then ``fault`` applied to the list of members or their join."""

    def __init__(self, entry, fault):
        self.entry, self.fault = entry, fault

    def __getattr__(self, name):
        return getattr(self.entry, name)

    def call(self, payload):
        header = self.entry.header
        crc = 0 if self.fault == "control" else None
        members = [control.gzip_member(p, 6, header, crc=crc) for p in payload.parts]
        if self.fault == "left_out":
            members.pop(3)
        elif self.fault == "swapped":
            members[0], members[1] = members[1], members[0]
        out = b"".join(members)
        if self.fault == "altered":
            out = bytearray(out)
            out[len(out) // 2] ^= 0x10
            out = bytes(out)
        elif self.fault == "trailing":
            out += b"\x00" * 4
        return out


def test_sound_stand_in_is_correct(cut, entry):
    res = run_cell(cut, Planted(entry, "sound"))
    assert res["correct"] is True
    assert res["checks"] and all(c["value"] == 0 for c in res["checks"].values())


@pytest.mark.parametrize("fault", ["left_out", "swapped", "altered", "trailing", "control"])
def test_fault_is_not_correct(cut, entry, fault):
    res = run_cell(cut, Planted(entry, fault))
    assert res["correct"] is False
    assert sum(c["value"] for c in res["checks"].values()) >= 1


def test_judge_counts_each_fault_on_the_whole_corpus(entry):
    x = inputs.make_input(inputs.load_corpus("calgary"), 3_141_622, 2147483659, 1)
    payload = entry.prepare(x)
    rng = np.random.default_rng(0)
    sound = Planted(entry, "sound").call(payload)
    assert entry.judge(x, sound, rng) == {"members": 0, "header": 0, "bytes": 0, "trailer": 0}
    assert entry.judge(x, Planted(entry, "control").call(payload), rng)["trailer"] == 14
    assert entry.judge(x, Planted(entry, "swapped").call(payload), rng)["bytes"] == 2
    assert entry.judge(x, Planted(entry, "trailing").call(payload), rng)["members"] == 1
    assert entry.judge(x, sound[:-20], rng)["members"] == 1
    assert entry.judge(x, b"", rng)["members"] == 1


def _counter_metrics(cell):
    return dict(cell, per_layer=[m for m in cell["per_layer"]
                                 if m["name"] in ("row_fill_pct.compress",
                                                  "batches_per_MB.compress")])


def test_counter_metrics_read_the_program_on_the_cpu(monkeypatch, cut):
    from decompress_tpu_torch import de

    monkeypatch.setattr(de, "SEGMENT_SIZE", SMALL_SEGMENT)
    before = dict(de.BATCH_COUNTS)
    res = run_cell(_counter_metrics(cut), trace=True)
    assert res["correct"] is True
    rows = 1 + 2 + 4 + 1 + 1
    passes = (de.BATCH_COUNTS["batches"] - before.get("batches", 0)) // len(CUT)
    assert passes >= 3  # two in set-up, at least one in the window
    m = res["metrics"]
    assert m["row_fill_pct.compress"]["value"] == pytest.approx(
        100 * sum(CUT) / (rows * SMALL_SEGMENT))
    assert m["batches_per_MB.compress"]["value"] == pytest.approx(len(CUT) / (sum(CUT) / 1e6))


def test_counter_metrics_read_nothing_without_the_counter(monkeypatch, cut):
    """The metrics' reader finds a ``de`` with no ``BATCH_COUNTS``, as in
    an older checkout; the program runs as it is."""
    import types

    import decompress_tpu_torch
    from decompress_tpu_torch import de

    monkeypatch.setattr(de, "SEGMENT_SIZE", SMALL_SEGMENT)
    monkeypatch.setattr(decompress_tpu_torch, "de", types.SimpleNamespace())
    batch_counts.start()
    assert batch_counts.delta() is None
    res = run_cell(_counter_metrics(cut), trace=True)
    assert res["correct"] is True
    assert "row_fill_pct.compress" not in res["metrics"]
    assert "batches_per_MB.compress" not in res["metrics"]


def test_only_the_harness_measure_notes_the_counter(monkeypatch):
    monkeypatch.setattr(batch_counts, "_state", {"before": None, "delta": None})
    spec.load_module("metrics", "row_fill_pct.compress")
    assert batch_counts.delta() is None
    ctx = {"kind": "decompress", "counted": 1_000_000}
    assert spec.load_module("metrics", "batches_per_MB.compress").read(ctx) is None
