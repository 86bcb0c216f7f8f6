"""The port's tracing (``utils.profiling``) on the CPU.

* Tracing off (the default): a span is one shared do-nothing object,
  records nothing and opens no ``record_function`` range, on every path,
  under a running profiler too.
* Tracing on: each span records its parent and its call id; a ``call``
  opens a new id only where none is open on its thread; blocks that nest
  each get the spans closed inside them; a span opens a range only while
  a profiler runs inside a block that asks for ranges
  (``device_trace``), and reads the thread's CPU time only where asked to
  (``cpu=True``: the host stages whose metrics read CPU time).
* On a one-shot ``gz.compress``, an archive write and an archive read:
  every span name of the path fires, spans nest inside their parents on
  one thread, the self intervals of each call's spans partition the call,
  no span opens inside a program's function, and the CPU moves none of
  the transfer or replay counters (they count copies and replays on a
  card).  ``processes.gather`` fires in the two-process writer
  (``test_torch_dist.py``).
"""

import collections
import gzip
import threading

import pytest
import torch

from decompress_tpu_torch import gz
from decompress_tpu_torch.ops import graphs, transfer
from decompress_tpu_torch.parallel import sharded
from decompress_tpu_torch.utils import profiling

DATA = (b"tracing the port's stages, one layer a span; " * 400
        + bytes(range(256)) * 20)[:14000]
MEMBER = 4096

#: the spans that read the thread's CPU time
CPU = {"plan.blocks", "roundb.tables", "decode.plan", "decode.expand"}
#: span names each path must show on the CPU (``transfer.fetch`` queues
#: copies from a card only)
WRITE = {"call", "schedule.stage", "schedule.assemble", "transfer.upload", "transfer.wait",
         "programs.dispatch", "roundb.tables", "plan.blocks"}
PATHS = {"gz.compress": WRITE, "sharded_gzip_compress": WRITE,
         "sharded_gzip_decompress": {"call", "decode.plan", "schedule.stage",
                                     "transfer.upload", "transfer.wait", "decode.expand",
                                     "schedule.assemble"}}


@pytest.fixture(scope="module")
def traced():
    """{entry: (output, records)} of each path, traced on the CPU, with
    the counters before and after."""
    counters = (sum(graphs.REPLAYS.values()), dict(transfer.COUNTS))
    out = {}
    with profiling.tracing() as recs:
        z = gz.compress(DATA, 6, device="cpu")
    out["gz.compress"] = (z, recs)
    with profiling.tracing() as recs:
        arch = sharded.sharded_gzip_compress(DATA, 6, member_size=MEMBER, device="cpu")
    out["sharded_gzip_compress"] = (arch, recs)
    with profiling.tracing() as recs:
        back = sharded.sharded_gzip_decompress(arch, device="cpu")
    out["sharded_gzip_decompress"] = (back, recs)
    return out, counters, (sum(graphs.REPLAYS.values()), dict(transfer.COUNTS))


def _spy_ranges(monkeypatch) -> list:
    opened = []
    real = torch.profiler.record_function

    def spy(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    return opened


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    opened = _spy_ranges(monkeypatch)
    assert not profiling.enabled()
    assert profiling.span("call") is profiling.span("plan.blocks", cpu=True)
    with profile(activities=[ProfilerActivity.CPU]):
        arch = sharded.sharded_gzip_compress(DATA, 6, member_size=MEMBER, device="cpu")
        assert sharded.sharded_gzip_decompress(arch, device="cpu") == DATA
        assert gzip.decompress(gz.compress(DATA[:3000], 6, device="cpu")) == DATA[:3000]
    assert opened == []
    with profiling.tracing() as recs:
        pass
    assert recs == []


def test_on_carries_parent_and_call_id(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    opened = _spy_ranges(monkeypatch)
    with profiling.tracing() as outer:
        with profiling.span("schedule.stage"):
            pass
        with profiling.span("call") as a:
            with profiling.tracing() as inner:
                with profiling.span("call") as b, profiling.span("plan.blocks", cpu=True) as c:
                    pass
        assert opened == []  # no profiler runs
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.span("call") as d:
                pass
            assert opened == []  # no block asks for ranges
            with profiling.tracing(ranges=True), profiling.span("schedule.stage"):
                pass
            with profiling.span("transfer.wait"):  # the ranges' block is closed
                pass
    assert opened == ["schedule.stage"]
    by = {r.id: r for r in outer}
    assert [r.name for r in inner] == ["plan.blocks", "call"]
    assert by[c.id].parent == b.id and by[b.id].parent == a.id and by[a.id].parent == 0
    stage = next(r for r in outer if r.name == "schedule.stage")
    assert stage.call == 0 and stage.parent == 0
    assert by[a.id].call == by[b.id].call == by[c.id].call != by[d.id].call != 0
    assert {r.thread for r in outer} == {threading.get_ident()}
    assert all(r.start_ns <= r.end_ns for r in outer)
    assert by[c.id].cpu_ns >= 0
    assert [r.name for r in outer if r.cpu_ns is not None] == ["plan.blocks"]


def test_spans_of_other_threads_have_their_own_stack():
    with profiling.tracing() as recs:
        with profiling.span("call"):
            t = threading.Thread(target=lambda: profiling.span("plan.blocks").__enter__()
                                 .__exit__(None, None, None))
            t.start()
            t.join()
    other = next(r for r in recs if r.name == "plan.blocks")
    assert other.parent == 0 and other.call == 0 and other.thread != threading.get_ident()


def test_spanned_keeps_the_function():
    def f(x, *, y=1):
        """doc"""
        return x + y

    g = profiling.spanned("plan.blocks")(f)
    h = profiling.spanned("decode.plan", cpu=True)(f)
    assert g.__wrapped__ is f and g.__doc__ == "doc" and g(1, y=2) == 3
    with profiling.tracing() as recs:
        assert g(2) == 3 and h(3) == 4
    assert [(r.name, r.cpu_ns is None) for r in recs] == [("plan.blocks", True),
                                                          ("decode.plan", False)]


@pytest.mark.parametrize("entry", sorted(PATHS))
def test_every_span_of_the_path_fires(traced, entry):
    out, _, _ = traced
    result, recs = out[entry]
    assert {r.name for r in recs} == PATHS[entry]
    calls = [r for r in recs if r.name == "call"]
    assert len(calls) == 1
    assert {r.name for r in recs if r.cpu_ns is not None} == PATHS[entry] & CPU
    assert all(r.call == calls[0].call for r in recs)
    assert gzip.decompress(out["sharded_gzip_compress"][0]) == DATA
    assert gzip.decompress(out["gz.compress"][0]) == DATA
    assert out["sharded_gzip_decompress"][0] == DATA


def _self_intervals(recs) -> dict:
    """{span id: its interval less its children's}, with children checked
    to lie inside their parent and apart from each other."""
    kids = collections.defaultdict(list)
    for r in recs:
        kids[r.parent].append(r)
    own = {}
    for r in recs:
        cs = sorted(kids[r.id], key=lambda c: c.start_ns)
        edge = r.start_ns
        pieces = []
        for c in cs:
            assert r.start_ns <= c.start_ns <= c.end_ns <= r.end_ns and c.thread == r.thread
            assert c.start_ns >= edge
            pieces.append((edge, c.start_ns))
            edge = c.end_ns
        pieces.append((edge, r.end_ns))
        own[r.id] = pieces
    return own


@pytest.mark.parametrize("entry", sorted(PATHS))
def test_self_intervals_partition_each_call(traced, entry):
    recs = traced[0][entry][1]
    own = _self_intervals(recs)
    call = next(r for r in recs if r.name == "call")
    pieces = sorted(p for pcs in own.values() for p in pcs)
    assert pieces[0][0] == call.start_ns and pieces[-1][1] == call.end_ns
    assert all(a[1] <= b[0] for a, b in zip(pieces, pieces[1:]))
    assert sum(e - s for s, e in pieces) == call.end_ns - call.start_ns


@pytest.mark.parametrize("entry", sorted(PATHS))
def test_no_span_inside_a_program(traced, entry):
    recs = traced[0][entry][1]
    by = {r.id: r for r in recs}
    for r in recs:
        p = by.get(r.parent)
        while p is not None:
            assert p.name != "programs.dispatch", r
            p = by.get(p.parent)


def test_cpu_moves_no_card_counter(traced):
    _, before, after = traced
    assert before == after


def test_device_trace_turns_tracing_on(tmp_path):
    with profiling.device_trace(tmp_path) as prof:
        assert profiling.enabled()
        gz.compress(DATA[:2000], 6, device="cpu")
    assert not profiling.enabled()
    assert {"call", "plan.blocks", "programs.dispatch"} <= {r.name for r in prof.spans}
    assert '"plan.blocks"' in (tmp_path / "trace.json").read_text()
