"""The program's own spans and counters in the traced run
(``benchmark/program_spans.py``): self intervals, idle time by span and
gap labels on fake records; arming the program's tracing only from the
harness's ``measure``, dropping a window that was never read, and
collecting on the CPU; nothing read from a program without it.  On the
card: the program's span names are never counted as device time, and the
traced run reports the metrics that read its spans and counters."""

import collections
import io

import pytest

from benchmark import program_spans, spec

Rec = collections.namedtuple("Rec", "name start_ns end_ns cpu_ns thread id parent call")

#: a call [0, 100] holding A [10, 40] (holding B [20, 30]) and C [50, 60];
#: A and B read the thread's CPU time
RECORDS = [Rec("B", 20, 30, 7, 1, 3, 2, 1), Rec("A", 10, 40, 20, 1, 2, 1, 1),
           Rec("C", 50, 60, None, 1, 4, 1, 1), Rec("call", 0, 100, None, 1, 1, 0, 1)]
#: the metric files that read the program's spans and counters
PROGRAM_METRICS = {"compress": ["transfer_ms_per_MB.compress", "schedule_host_ms_per_MB.compress",
                                "replays_per_MB.compress", "idle_unattributed_pct.compress",
                                "copied_MB_per_MB.compress", "waits_per_MB.compress"],
                   "decompress": ["transfer_ms_per_MB.decompress",
                                  "idle_unattributed_pct.decompress",
                                  "copied_MB_per_MB.decompress", "waits_per_MB.decompress"]}
GAPS = [(90, 200), (25, 55), (0, 15)]


def test_idle_inside_intervals():
    idle = program_spans._Idle(GAPS)
    assert idle.within([0, 0, 20, 100, 300], [100, 15, 30, 300, 400]).tolist() == \
        [55, 15, 5, 100, 0]
    assert program_spans._Idle([]).within([0], [10]).tolist() == [0]


def test_self_times_subtract_children():
    t = program_spans.self_times(RECORDS, program_spans._Idle(GAPS))
    assert {n: v["wall_ns"] for n, v in t.items()} == {"call": 60, "A": 20, "B": 10, "C": 10}
    assert {n: v["idle_ns"] for n, v in t.items()} == {"call": 30, "A": 15, "B": 5, "C": 5}
    # CPU time over the whole spans, where they read it
    assert {n: v["cpu_ns"] for n, v in t.items()} == {"call": None, "A": 20, "B": 7, "C": None}
    assert t["call"]["n"] == 1
    # the self intervals of a call's spans partition it
    assert sum(v["wall_ns"] for v in t.values()) == 100


def _fake_run(monkeypatch, records, delta=None, gaps=GAPS, harness_spans=None):
    result = {"records": records, "delta": delta or {"replays": 6, "uploaded": 3_000_000,
                                                     "fetched": 1_000_000, "waits": 8},
              "analysis": None}
    monkeypatch.setattr(program_spans, "_collect", lambda: result)
    ctx = {"kind": "compress", "counted": 2_000_000,
           "device": {"gaps": sorted(gaps, key=lambda g: g[0] - g[1])},
           "spans": harness_spans or {}}
    return ctx


def test_analysis_reads_and_labels(monkeypatch, capsys):
    outside = Rec("call", 300, 400, None, 1, 5, 0, 2)
    ctx = _fake_run(monkeypatch, RECORDS + [outside], gaps=GAPS + [(500, 520)],
                    harness_spans={"plan_blocks": [(505, 530, 0)]})
    a = program_spans.analysis(ctx)
    assert a["idle_ns"] == 110 + 30 + 20 + 15
    assert a["outside_calls_ns"] == 175 - 55  # the first call holds 55 of it, the second none
    assert program_spans.unattributed_pct(ctx) == pytest.approx(100 * 30 / 175)
    assert program_spans.ms_per_mb(ctx, lambda n: n in ("A", "B")) == \
        pytest.approx(30 / 1e6 / 2)
    assert program_spans.per_mb(ctx, "replays") == 3
    assert program_spans.per_mb(ctx, "uploaded", "fetched", "absent") == 2_000_000
    assert spec.load_module("metrics", "copied_MB_per_MB.compress").read(ctx) == 2
    assert spec.load_module("metrics", "waits_per_MB.compress").read(ctx) == 4
    assert spec.load_module("metrics", "waits_per_MB.decompress").read(ctx) is None
    assert program_spans.analysis(ctx) is a  # worked out once
    log = capsys.readouterr().err
    # (90, 200) under the call's own time; (25, 55) a tie of the call and
    # A, the first found; (500, 520) under no program span, but under the
    # harness's plan_blocks
    assert 'longest gaps [["call", 1.1e-07], ["A", 3e-08], ["plan_blocks", 2e-08], ' \
        '["call", 1.5e-08]]' in log
    assert '"A": {"n": 1, "wall_ms": 2e-05, "idle_s": 1.5e-08, "cpu_ms_per_MB": 1e-05}' in log
    assert '"C": {"n": 1, "wall_ms": 1e-05, "idle_s": 5e-09}' in log
    assert 'program counters in the window {"replays": 6, ' in log


def test_gap_labels():
    children = collections.defaultdict(list)
    for r in RECORDS:
        children[r.parent].append(r)
    label = program_spans.label_gap
    assert label((90, 200), RECORDS, children, {}) == "call"
    assert label((25, 55), RECORDS, children, {}) == "A"
    assert label((21, 29), RECORDS, children, {}) == "B"
    assert label((500, 520), RECORDS, children, {"x": [(0, 510, 0)]}) == "x"
    assert label((500, 520), RECORDS, children, {}) == "host"


def test_no_call_or_no_device_reads_nothing(monkeypatch):
    ctx = _fake_run(monkeypatch, [Rec("A", 0, 10, 1, 1, 1, 0, 0)])
    assert program_spans.analysis(ctx) is None
    assert program_spans.ms_per_mb(ctx, lambda n: True) is None
    assert program_spans.per_mb(ctx, "waits") is None
    ctx = _fake_run(monkeypatch, RECORDS)
    del ctx["device"]
    assert program_spans.unattributed_pct(ctx) is None
    assert program_spans.per_mb(ctx, "replays") == 3


def test_a_program_without_tracing_gives_nothing(monkeypatch):
    monkeypatch.setattr(program_spans, "_state", dict(program_spans._state, tracing=None,
                                                      result=None))
    monkeypatch.setattr(program_spans, "_program", lambda: None)
    program_spans.start()
    assert program_spans._state["tracing"] is None
    for kind, names in PROGRAM_METRICS.items():
        ctx = {"kind": kind, "counted": 1_000_000}
        for name in names:
            assert spec.load_module("metrics", name).read(ctx) is None


def test_arm_and_collect_the_program_on_the_cpu(monkeypatch):
    from decompress_tpu_torch import gz
    from decompress_tpu_torch.utils import profiling

    monkeypatch.setattr(program_spans, "_state", dict(program_spans._state, tracing=None,
                                                      result=None))
    program_spans.start()
    records = program_spans._state["records"]
    program_spans.start()  # no call recorded yet: started once
    assert profiling.enabled() and program_spans._state["records"] is records
    data = b"arm, call, collect " * 600
    gz.compress(data, 6, device="cpu")
    ctx = {"kind": "compress", "counted": len(data)}
    mod = spec.load_module("metrics", "transfer_ms_per_MB.compress")  # loading arms nothing new
    value = mod.read(ctx)
    assert not profiling.enabled()
    assert value > 0
    a = program_spans.analysis(ctx, err=io.StringIO())
    assert {"call", "plan.blocks", "roundb.tables", "transfer.upload"} <= set(a["spans"])
    assert a["delta"]["replays"] == 0  # no replay on the CPU
    assert spec.load_module("metrics", "transfer_ms_per_MB.decompress").read(ctx) is None
    # the next run's start begins afresh
    program_spans.start()
    assert profiling.enabled() and program_spans._state["result"] is None
    program_spans._collect()
    assert not profiling.enabled()


def test_only_the_harness_measure_arms(monkeypatch):
    """Loading the metric files anywhere but in ``harness.measure`` (a
    spec check, a result's read) leaves the program's tracing off; a load
    from ``measure`` turns it on, and a later measure's load drops the
    calls of a window that was never read."""
    from decompress_tpu_torch import gz
    from decompress_tpu_torch.utils import profiling

    monkeypatch.setattr(program_spans, "_state", dict(program_spans._state, tracing=None,
                                                      result=None))
    for names in PROGRAM_METRICS.values():
        for name in names:
            spec.load_module("metrics", name)
    program_spans.arm()
    assert not profiling.enabled() and program_spans._state["tracing"] is None

    def measure():  # stands for the harness's, which loads the metric files
        return [spec.load_module("metrics", n) for n in PROGRAM_METRICS["compress"]]

    fake = type(measure)(measure.__code__, {"__name__": "benchmark.harness", "spec": spec,
                                            "PROGRAM_METRICS": PROGRAM_METRICS})
    fake()
    assert profiling.enabled()
    records = program_spans._state["records"]
    gz.compress(b"a window never read " * 300, 6, device="cpu")
    assert any(r.name == "call" for r in records)
    fake()  # the next measure: the stale window is dropped
    assert profiling.enabled() and program_spans._state["records"] is not records
    assert program_spans._state["records"] == []
    program_spans._collect()
    assert not profiling.enabled()


@pytest.mark.cuda
def test_span_names_are_not_device_time():
    """The program's spans open profiler ranges that the profile projects
    onto the device's timeline; the traced run counts none of them as
    device time, and reports the metrics that read the spans."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from benchmark.tests.test_bench_card import run

    for cell, metrics in (("archive6-calgary-16m-write-x1",
                            PROGRAM_METRICS["compress"]),
                          ("archive6-calgary-16m-read-x1", PROGRAM_METRICS["decompress"])):
        line = run(cell, 1)
        assert line["correct"] is True
        names = {n for n, _ in line["breakdown"]["device_ops"]}
        assert not {n for n in names if n == "call" or n.split(".")[0] in (
            "schedule", "transfer", "programs", "roundb", "plan", "processes", "decode")}
        for m in metrics:
            assert line["metrics"][m]["value"] > 0, m
