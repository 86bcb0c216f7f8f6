"""What the traced run reads: spans the harness wraps around the program's
functions, and the device's activity from ``torch.profiler``.

* :class:`Spans` replaces module attributes (``"pkg.module:function"``)
  by wrappers that record each call's wall interval (on the epoch clock
  the profiler's events use) and the calling thread's CPU time.  They are
  set only in the traced run, and taken out after it.
* :func:`device_activity` takes the device's kernels and copies of a
  profile inside the window: their merged busy intervals, time and
  launches by name, and the idle gaps between them.
"""

from __future__ import annotations

import collections
import functools
import importlib
import time


class Spans:
    """Wrappers around program functions, by span name."""

    def __init__(self, targets: dict[str, list[str]]):
        self.targets = targets
        self.records: dict[str, list] = {name: [] for name in targets}
        self._saved: list = []

    def _wrap(self, name: str, fn):
        records = self.records[name]

        @functools.wraps(fn)
        def span(*args, **kwargs):
            c0, t0 = time.thread_time_ns(), time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                records.append((t0, time.time_ns(), time.thread_time_ns() - c0))

        return span

    def install(self) -> None:
        for name, paths in self.targets.items():
            for path in paths:
                mod_name, attr = path.split(":")
                mod = importlib.import_module(mod_name)
                fn = getattr(mod, attr)
                self._saved.append((mod, attr, fn))
                setattr(mod, attr, self._wrap(name, fn))

    def remove(self) -> None:
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()

    def silent(self) -> list[str]:
        """Spans that saw no call."""
        return [name for name, recs in self.records.items() if not recs]


def _merge(intervals: list) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def device_events(prof) -> list:
    """(name, start ns, end ns) of every device event of a profile (kernels,
    copies and sets), on the epoch clock.  The ranges that the program's
    ``record_function`` scopes project onto the device's timeline span
    kernels and the gaps between them, and are left out: flagged as user
    annotations, or known by their names, which are the host scopes'."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    scopes = {e.name() for e in events if e.device_type() != cuda and e.is_user_annotation()}
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
            if e.device_type() == cuda and e.duration_ns() > 0
            and not e.is_user_annotation() and e.name() not in scopes]


def device_activity(events: list, t0_ns: int, t1_ns: int) -> dict:
    """The device's activity in the window [t0_ns, t1_ns]: ``busy_s``
    (the merged length of every event), ``window_s``, ``by_name``
    ({name: [seconds, launches]}) and ``gaps`` ([(start ns, end ns)] of
    idle time, longest first)."""
    inside = [(n, max(s, t0_ns), min(e, t1_ns)) for n, s, e in events
              if e > t0_ns and s < t1_ns]
    by_name: dict = collections.defaultdict(lambda: [0.0, 0])
    for n, s, e in inside:
        by_name[n][0] += (e - s) / 1e9
        by_name[n][1] += 1
    merged = _merge([[s, e] for _, s, e in inside])
    busy = sum(e - s for s, e in merged)
    edges = [t0_ns] + [x for s, e in merged for x in (s, e)] + [t1_ns]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    return {"busy_s": busy / 1e9, "window_s": (t1_ns - t0_ns) / 1e9,
            "by_name": dict(by_name), "gaps": gaps, "events": len(inside)}


def label_gap(gap: tuple, spans: dict) -> str:
    """The span that overlaps idle gap ``gap`` most, or ``host`` where
    none does."""
    best, name = 0, "host"
    for span, recs in spans.items():
        cover = sum(max(0, min(e, gap[1]) - max(s, gap[0])) for s, e, _ in recs)
        if cover > best:
            best, name = cover, span
    return name
