"""What the traced run reads of the program's own tracing: the spans of
``decompress_tpu_torch.utils.profiling`` and the counters of
``ops.graphs`` (replays) and ``ops.transfer`` (bytes each way, waits).

``harness.measure`` loads a traced run's per-layer metric files after
set-up, just before the window opens; ``harness.result`` loads them again
to read them after the window; an untraced run never loads them.  A
metric file that reads the program's spans calls :func:`arm` when it
loads, and only a load from inside ``harness.measure`` turns the
program's tracing on (and notes its counters): a load from anywhere else
arms nothing.  Further arms before any call is recorded do nothing; an
arm that finds calls already recorded (a traced window that never got
read, its measure having raised) drops them and starts afresh.  The first
:func:`analysis` after the window turns tracing off again, takes the
counters' deltas and works out, once:

* each span's *self intervals*, its interval less its children's (spans
  nest on their thread, so a call's self intervals partition it): wall
  time in them by span name, and thread CPU time in the whole spans that
  read it (``cpu=True``);
* the window's idle time (``trace.device_activity``'s gaps) under each
  span name's self intervals, inside ``call`` spans but under no other
  span (``unattributed``), and outside every ``call`` (the harness's own
  time between calls);
* the longest gaps, each labelled by the span whose self intervals cover
  most of it, else by the harness's span that overlaps it most
  (``trace.label_gap``), else ``host``.

It prints these to the run's log.  A program without this tracing (an
older checkout) gives no records: every reader returns None.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from benchmark import trace

_state: dict = {"tracing": None, "records": None, "counters": None, "result": None}
#: the harness function whose load of the metric files arms the tracing
_MEASURE = ("benchmark.harness", "measure")


def _program():
    """(profiling, counters()) of the program, or None where it has no
    tracing of its own."""
    try:
        from decompress_tpu_torch.ops import graphs, transfer
        from decompress_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not all(hasattr(m, a) for m, a in ((profiling, "tracing"), (graphs, "REPLAYS"),
                                          (transfer, "COUNTS"))):
        return None

    def counters() -> dict:
        return {"replays": sum(graphs.REPLAYS.values()), **transfer.COUNTS}

    return profiling, counters


def _in_measure() -> bool:
    """Whether ``harness.measure`` is on the calling thread's stack."""
    f = sys._getframe(1)
    while f is not None:
        if (f.f_globals.get("__name__"), f.f_code.co_name) == _MEASURE:
            return True
        f = f.f_back
    return False


def arm() -> None:
    """Turn the program's tracing on for the traced window, where
    ``harness.measure`` loads the metric files (see the module's
    docstring); do nothing elsewhere."""
    if _in_measure():
        start()


def start() -> None:
    """Turn the program's tracing on, unless it is on with no call
    recorded yet; where calls are recorded, drop them first."""
    if _state["tracing"] is not None:
        if not any(r.name == "call" for r in _state["records"]):
            return
        _state["tracing"].__exit__(None, None, None)
        _state["tracing"] = None
    prog = _program()
    if prog is None:
        return
    profiling, counters = prog
    block = profiling.tracing()
    _state.update(tracing=block, records=block.__enter__(), counters=counters(),
                  result=None)


def _collect() -> dict | None:
    """Tracing off; the records and the counters' deltas since
    :func:`start` (kept until the next start), or None where nothing was
    started."""
    block = _state["tracing"]
    if block is not None:
        _state["tracing"] = None
        block.__exit__(None, None, None)
        _, counters = _program()
        now = counters()
        _state["result"] = {"records": _state["records"], "analysis": None,
                            "delta": {k: v - _state["counters"].get(k, 0)
                                      for k, v in now.items()}}
    return _state["result"]


class _Idle:
    """Idle time of the window's gaps inside any interval, by prefix sums
    over the gaps in order."""

    def __init__(self, gaps):
        g = np.array(sorted(gaps), dtype=np.int64).reshape(-1, 2)
        self.starts, self.ends = g[:, 0], g[:, 1]
        self.before = np.concatenate([[0], np.cumsum(self.ends - self.starts)])

    def upto(self, t: np.ndarray) -> np.ndarray:
        """Idle ns before each time in ``t``."""
        if self.starts.size == 0:
            return np.zeros_like(t)
        i = np.searchsorted(self.starts, t, side="right") - 1
        inside = np.where(i >= 0, np.minimum(t, self.ends[i]) - self.starts[i], 0)
        return self.before[np.maximum(i, 0)] * (i >= 0) + np.maximum(inside, 0)

    def within(self, s: np.ndarray, e: np.ndarray) -> np.ndarray:
        return self.upto(e) - self.upto(s)


def self_times(records: list, idle: _Idle | None = None) -> dict:
    """By span name: count, and wall and (with ``idle``) idle ns in its
    self intervals; thread CPU ns in the whole spans (``cpu_ns``, None for
    a name whose spans do not read it)."""
    index = {r.id: k for k, r in enumerate(records)}
    start = np.array([r.start_ns for r in records], np.int64)
    end = np.array([r.end_ns for r in records], np.int64)
    idl = idle.within(start, end) if idle is not None else np.zeros(len(records), np.int64)
    wall = end - start
    own = [wall.copy(), idl.copy()]
    kids = [(index[r.parent], k) for k, r in enumerate(records) if r.parent in index]
    if kids:
        parent, child = np.array(kids).T
        for total, whole in zip(own, (wall, idl)):
            np.subtract.at(total, parent, whole[child])
    out: dict = {}
    for k, r in enumerate(records):
        t = out.setdefault(r.name, {"n": 0, "wall_ns": 0, "idle_ns": 0, "cpu_ns": None})
        t["n"] += 1
        t["wall_ns"] += int(own[0][k])
        t["idle_ns"] += int(own[1][k])
        if r.cpu_ns is not None:
            t["cpu_ns"] = (t["cpu_ns"] or 0) + r.cpu_ns
    return out


def _cover(rec, kids: list, gap: tuple) -> int:
    def over(r):
        return max(0, min(r.end_ns, gap[1]) - max(r.start_ns, gap[0]))
    return over(rec) - sum(over(c) for c in kids)


def label_gap(gap: tuple, records: list, children: dict, harness_spans: dict) -> str:
    """The program span whose self intervals cover most of ``gap``; else
    the harness's span that overlaps it most; else ``host``."""
    best, name = 0, None
    for r in records:
        if r.end_ns > gap[0] and r.start_ns < gap[1]:
            c = _cover(r, children.get(r.id, []), gap)
            if c > best:
                best, name = c, r.name
    return name if name is not None else trace.label_gap(gap, harness_spans)


def analysis(ctx: dict, err=None) -> dict | None:
    """The traced window's program spans, counters and idle time by span
    (see the module's docstring), worked out and printed once (to ``err``,
    default the standard error); None where the program's tracing was
    not armed or recorded no call."""
    err = err if err is not None else sys.stderr
    res = _collect()
    if res is None or not any(r.name == "call" for r in res["records"]):
        return None
    if res["analysis"] is not None:
        return res["analysis"]
    records = res["records"]
    dev = ctx.get("device")
    idle = _Idle(dev["gaps"]) if dev is not None else None
    spans = self_times(records, idle)
    out = {"spans": spans, "delta": res["delta"], "mb": ctx["counted"] / 1e6}
    table = {n: {"n": t["n"], "wall_ms": t["wall_ns"] / 1e6, "idle_s": t["idle_ns"] / 1e9,
                 **({"cpu_ms_per_MB": t["cpu_ns"] / 1e6 / out["mb"]}
                    if t["cpu_ns"] is not None else {})}
             for n, t in sorted(spans.items())}
    print("program spans (wall and idle in self intervals; cpu_ms_per_MB over whole "
          "spans): " + json.dumps(table), file=err)
    print(f"program counters in the window {json.dumps(res['delta'])}", file=err)
    if idle is not None:
        total = int(idle.before[-1])
        calls = {}
        for r in records:  # each call's outermost span
            if r.name == "call" and (r.call not in calls or r.start_ns < calls[r.call].start_ns):
                calls[r.call] = r
        c = list(calls.values())
        inside = int(idle.within(np.array([r.start_ns for r in c], np.int64),
                                 np.array([r.end_ns for r in c], np.int64)).sum())
        out.update(idle_ns=total, outside_calls_ns=total - inside,
                   unattributed_ns=spans["call"]["idle_ns"])
        children: dict = {}
        for r in records:
            children.setdefault(r.parent, []).append(r)
        gaps = [[label_gap(g, records, children, ctx.get("spans", {})), (g[1] - g[0]) / 1e9]
                for g in dev["gaps"][:10]]
        print(f"program idle: {total / 1e9} s, outside every call {(total - inside) / 1e9} s, "
              f"in calls under no other span {out['unattributed_ns'] / 1e9} s; "
              f"longest gaps {json.dumps(gaps)}", file=err)
    res["analysis"] = out
    return out


def ms_per_mb(ctx: dict, pick) -> float | None:
    """Wall ms in the self intervals of the spans whose names ``pick``
    accepts, per MB counted."""
    a = analysis(ctx)
    if a is None:
        return None
    return sum(t["wall_ns"] for n, t in a["spans"].items() if pick(n)) / 1e6 / a["mb"]


def unattributed_pct(ctx: dict) -> float | None:
    """Share of the window's idle time inside calls under no span but
    ``call``, in %."""
    a = analysis(ctx)
    if a is None or "idle_ns" not in a or a["idle_ns"] <= 0:
        return None
    return 100.0 * a["unattributed_ns"] / a["idle_ns"]


def per_mb(ctx: dict, *counters: str) -> float | None:
    """The sum of the named counters' moves over the window, per MB
    counted."""
    a = analysis(ctx)
    if a is None:
        return None
    return sum(a["delta"].get(c, 0) for c in counters) / a["mb"]
