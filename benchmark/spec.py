"""The benchmark's data: ``BENCHMARK.json`` at the checkout's root, and the
files it names, found by name.

* a configuration: ``configs/<config>.json`` (the ``file`` of its entry);
* a traffic mix: ``traffic/<traffic>.json``;
* a metric, end-to-end or per-layer: ``metrics/<metric>.py``;
* a kernel's byte count: ``rooflines/<kernel>.py``;
* what a configuration's calls run: ``entries/<entry>.py``, the
  configuration's ``entry``.

A cell is one entry of ``workloads``; :func:`load_cell` gathers what it
needs.  Adding a cell, a mix or a metric adds files and entries and
edits none.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import types

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: pathlib.Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(kind: str, name: str) -> types.ModuleType:
    """``<kind>/<name>.py`` under the benchmark's folder, as a module."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, workload: str) -> bool:
    """Whether ``metric`` is reported in cell ``workload``."""
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, bench: dict | None = None) -> dict:
    """The cell ``workload``: its entry in ``workloads``, its
    configuration and traffic mix, and its end-to-end and per-layer
    metrics' entries."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return {
        "name": workload,
        "chips": cell["chips"],
        "config": load_json(ROOT / config["file"]),
        "traffic": load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m, workload)],
        "per_layer": [m for m in bench["per_layer"] if applies(m, workload)],
    }
