"""Tracing and timing helpers (counterpart of
``decompress_tpu/utils/profiling.py``).

:func:`device_trace` records the enclosed codec calls with
``torch.profiler`` (host and, where a card is present, CUDA activity)
and writes a Chrome trace; :func:`annotate` names a stage in such a trace
(``parallel.sharded`` opens ``lz77_analyze_dispatch`` and ``bitpack``);
:class:`FetchTimer` is a wall timer that waits for the card before it
stops.
"""

from __future__ import annotations

import contextlib
import pathlib
import time

import torch

#: where :func:`device_trace` writes by default, beside the package
TRACE_DIR = pathlib.Path(__file__).resolve().parent.parent.parent / "build" / "trace"


@contextlib.contextmanager
def device_trace(log_dir=TRACE_DIR):
    """Profile the enclosed codec calls and write ``<log_dir>/trace.json``
    (Chrome trace format; open it in Perfetto or chrome://tracing).
    Yields the profiler.  Usage::

        with profiling.device_trace("build/trace") as prof:
            de.deflate(data, 6)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))


def annotate(name: str):
    """Named profiler scope for a codec stage (shows up in traces)."""
    return torch.profiler.record_function(name)


class FetchTimer:
    """Wall timer that waits for the card before it stops: ``stop(result)``
    synchronizes the device of a CUDA tensor result (or of any CUDA tensor
    in a tuple or list of them)."""

    def __init__(self) -> None:
        self.laps: list[float] = []
        self._t0 = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        for t in result if isinstance(result, (tuple, list)) else (result,):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                torch.cuda.synchronize(t.device)
        dt = time.perf_counter() - self._t0
        self.laps.append(dt)
        return dt

    @property
    def median(self) -> float:
        xs = sorted(self.laps)
        return xs[len(xs) // 2] if xs else float("nan")
