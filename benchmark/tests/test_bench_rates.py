"""The window's arithmetic with a fake clock: whole calls only, the last
call finishing past ``--seconds``."""

import io
import json

import numpy as np
import pytest

from benchmark import harness

CELL = {
    "name": "fake", "chips": 1,
    "config": {"entry": "fake", "corpus": "calgary"},
    "traffic": {"inputs": 2, "input_bytes": 1000, "host_threads": 1},
    "end_to_end": [{"name": "compress_MBps"}, {"name": "ratio"}, {"name": "setup_s"}],
    "per_layer": [{"name": "call_p95_ms.compress"}],
}


class FakeClock:
    """A clock that moves only when a call advances it."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class FakeEntry:
    """Calls that take 0.3 s and 0.5 s of the fake clock by turns (the two
    warm calls of set-up first), and return a quarter of their input."""

    kind = "compress"
    kernels = ()

    def __init__(self, clock):
        self.clock = clock
        self.n = 0

    def prepare(self, data):
        return data

    def call(self, payload):
        self.clock.advance(0.5 if self.n % 2 else 0.3)
        self.n += 1
        return bytes(payload[: payload.size // 4])

    def judge(self, data, out, rng):
        return {"bytes": int(out != data[: data.size // 4].tobytes())}

    def counters(self):
        return {}

    def window_checks(self, delta):
        return {}

    def batches(self, n):
        return []


def run_fake(monkeypatch, trace=False):
    clock = FakeClock()
    monkeypatch.setattr(harness, "now", clock)
    out = io.StringIO()
    rc = harness.run(CELL, 3, 1.0, trace, t_start=0.0, device="cpu",
                     entry=FakeEntry(clock), out=out, err=io.StringIO())
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_whole_calls_and_the_last_past_the_window(monkeypatch):
    res = run_fake(monkeypatch)
    # calls start at 0, .3 and .8 of the window (ends 1.1): 3 calls of 1000
    # bytes over 1.1 s; none starts at 1.1
    assert res["attempted"] == 3
    assert res["metrics"]["compress_MBps"]["value"] == pytest.approx(3000 / 1.1 / 1e6)
    assert res["metrics"]["ratio"]["value"] == pytest.approx(250 / 1000)
    assert res["correct"] is True
    assert list(res)[-1] == "checks"


def test_call_p95_over_every_call(monkeypatch):
    res = run_fake(monkeypatch, trace=True)
    walls = [300.0, 500.0, 300.0]
    import statistics

    want = statistics.quantiles(walls, n=20)[-1]
    assert res["metrics"]["call_p95_ms.compress"]["value"] == pytest.approx(want)


def test_rate_counts_decoded_bytes_for_a_decode(monkeypatch):
    from benchmark import readers

    ctx = {"kind": "decompress", "counted": 5_000_000, "window_s": 2.5}
    assert readers.rate_mbps(ctx) == pytest.approx(2.0)
    assert np.isclose(readers.rate_mbps(dict(ctx, window_s=0.5)), 10.0)
