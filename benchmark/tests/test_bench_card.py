"""Short runs of one-card cells through the benchmark's own command,
on the card (marked ``cuda``; skips without one)."""

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_is_correct(card, trace):
    line = run("gz6-calgary-8m-x1", trace)
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
    if trace:
        assert 0 < line["device"]["busy_s"] < line["device"]["window_s"]
        assert 0 < line["metrics"]["compress_kernels_roofline"]["value"] <= 100


def test_annotation_ranges_are_not_device_time(card):
    """The archive writer's ``annotate`` scopes appear on the device's
    timeline in the profile; the traced run counts none as device time."""
    line = run("archive6-calgary-16m-write-x1", 1)
    assert line["correct"] is True
    names = {n for n, _ in line["breakdown"]["device_ops"]}
    assert not names & {"bitpack", "lz77_analyze_dispatch"}


def run(workload, trace):
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload, "--seed",
         "2147483999", "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return json.loads(res.stdout.strip().splitlines()[-1])
