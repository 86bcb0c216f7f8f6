"""``BENCHMARK.json`` keeps the benchmark's format, and every name in it
finds its file: configurations, traffic mixes, entries, metrics and the
rooflines of each entry's kernels."""

import json
import pathlib
import re

import pytest

from benchmark import spec

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files_and_reports(cell):
    c = spec.load_cell(cell, BENCH)
    entry = spec.load_module("entries", c["config"]["entry"])
    assert entry.make
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and c["per_layer"]
    for m in c["end_to_end"] + c["per_layer"]:
        mod = spec.load_module("metrics", m["name"])
        assert mod.UNIT == m["unit"]
    for m in c["per_layer"]:
        assert m["moves"] in e2e
    for kernel in getattr(entry, "KERNELS", ()):
        spec.load_module("rooflines", kernel)


def test_every_config_is_used_and_its_file_is_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
