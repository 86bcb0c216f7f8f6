"""Spans: the harness's wrappers around the program's functions record
calls in the traced run, and one that sees no call fails the run."""

import io

import pytest

from benchmark import harness, spec, trace
from benchmark.tests.test_bench_rates import CELL, FakeClock, FakeEntry


def test_wrapper_records_and_comes_out():
    from decompress_tpu_torch import de

    original = de.plan_blocks
    spans = trace.Spans({"plan_blocks": ["decompress_tpu_torch.de:plan_blocks"]})
    spans.install()
    try:
        assert de.plan_blocks is not original
        assert spans.silent() == ["plan_blocks"]
    finally:
        spans.remove()
    assert de.plan_blocks is original


def test_silent_span_fails_the_traced_run(monkeypatch):
    class Silent:
        UNIT = "ms/MB"
        SPANS = {"never": ["decompress_tpu_torch.de:plan_blocks"]}

        @staticmethod
        def read(ctx):
            return 1.0

    real = spec.load_module
    monkeypatch.setattr(spec, "load_module",
                        lambda kind, name: Silent if kind == "metrics" else real(kind, name))
    clock = FakeClock()
    monkeypatch.setattr(harness, "now", clock)
    with pytest.raises(RuntimeError, match="spans saw no call"):
        harness.run(CELL, 3, 1.0, True, t_start=0.0, device="cpu", entry=FakeEntry(clock),
                    out=io.StringIO(), err=io.StringIO())


def test_gap_takes_the_span_that_covers_it():
    spans = {"plan_blocks": [(10, 50, 0)], "decode_plan": [(40, 100, 0)]}
    assert trace.label_gap((45, 95), spans) == "decode_plan"
    assert trace.label_gap((200, 300), spans) == "host"


def test_device_activity_merges_and_finds_gaps():
    events = [("k1", 10, 30), ("k2", 20, 40), ("Memcpy HtoD", 60, 70)]
    act = trace.device_activity(events, 0, 100)
    assert act["busy_s"] == pytest.approx(40e-9)
    assert act["window_s"] == pytest.approx(100e-9)
    assert act["gaps"][0] == (70, 100)
    assert sorted(act["gaps"]) == [(0, 10), (40, 60), (70, 100)]
    assert act["by_name"]["k1"] == [pytest.approx(20e-9), 1]


def test_device_events_leave_out_annotation_ranges():
    import types

    import torch

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def event(name, device, start, dur, flagged=False):
        return types.SimpleNamespace(
            name=lambda: name, device_type=lambda: device, is_user_annotation=lambda: flagged,
            start_ns=lambda: start, duration_ns=lambda: dur)

    events = [event("bitpack", cuda, 0, 100, flagged=True),
              event("lz77_analyze_dispatch", cuda, 0, 50),  # not flagged: known by name
              event("slots_kernel", cuda, 10, 20),
              event("Memcpy HtoD", cuda, 40, 5),
              event("bitpack", cpu, 0, 100, flagged=True),
              event("lz77_analyze_dispatch", cpu, 0, 50, flagged=True)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    assert trace.device_events(prof) == [("slots_kernel", 10, 30), ("Memcpy HtoD", 40, 45)]
