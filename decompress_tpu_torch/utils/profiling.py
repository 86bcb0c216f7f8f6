"""Tracing of the port's stages (counterpart of
``decompress_tpu/utils/profiling.py``).

:func:`span` names a stage of a call.  Tracing is off by default, and a
span then costs one check of a flag and records nothing.  Inside
:func:`tracing` (or :func:`device_trace`) every span opened records, in
memory, a :class:`Span`: its name, its interval on ``time.time_ns()``
(the epoch clock of ``torch.profiler``'s device events), the thread,
its parent span and the id of the call it belongs to; a span opened with
``cpu=True`` also reads the calling thread's CPU time inside it (that
clock can be a system call, so only the spans whose readers need CPU
time read it).  Inside :func:`device_trace` (or ``tracing(ranges=True)``
under a running profiler) a span also opens a
``torch.profiler.record_function`` range of its name, so that the
profile shows the stages beside the card's kernels; plain
:func:`tracing` opens none, since a range costs more than the span.

A ``call`` span wraps each entry point (``gz.compress``, the sharded
archive's write and read, the multi-process writer) and opens a new call
id where no ``call`` is open on its thread; every span opened under it
carries that id.  Spans nest: a span's *self intervals* are its interval
less its children's, and together they partition each call on its
thread.  The names, one layer each (PERF.md §3)::

    call                entry point
    schedule.stage      host build of a batch's or chunk's arrays
    schedule.assemble   output assembly after the card's results are read
    transfer.upload     host-to-card copies (pinned and pageable)
    transfer.fetch      card-to-host copies queued behind their work
    transfer.wait       the host waiting on the card: events, blocking reads
    programs.dispatch   a captured program's key, lookup and replay
    roundb.tables       round B's host cost tables and hot strides
    plan.blocks         host block planning
    processes.wait      the sizes' all-gather: the wait for the slowest process
    processes.gather    the processes' all-gathers of pieces and metadata
    processes.index     the archive's index rebuilt from every process's metadata
    decode.plan         the decode's host plan
    decode.expand       the decode's expansion of commands into bytes

Spans sit at stage boundaries only, never inside per-member or per-row
loops, and never inside a captured program's function.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import pathlib
import threading
import time
import typing

import torch

#: where :func:`device_trace` writes by default, beside the package
TRACE_DIR = pathlib.Path(__file__).resolve().parent.parent.parent / "build" / "trace"


class Span(typing.NamedTuple):
    """One closed span: ``start_ns``/``end_ns`` on ``time.time_ns()``,
    ``cpu_ns`` the calling thread's CPU time inside it (None where the
    span was not opened with ``cpu=True``), ``id`` unique in the process,
    ``parent`` the enclosing span's id (0 for none) and ``call`` the id of
    its call (0 outside every call)."""

    name: str
    start_ns: int
    end_ns: int
    cpu_ns: int | None
    thread: int
    id: int
    parent: int
    call: int


#: the record lists of the open :func:`tracing` blocks; empty = tracing off
_sinks: tuple = ()
#: the open blocks that ask for profiler ranges
_ranges = 0
_ids = itertools.count(1)
_calls = itertools.count(1)
_local = threading.local()
#: the span of a process that is not tracing
_OFF = contextlib.nullcontext()


class _Open:
    """A span being recorded (see :func:`span`)."""

    __slots__ = ("name", "cpu", "id", "parent", "call", "t0", "c0", "range")

    def __init__(self, name: str, cpu: bool):
        self.name = name
        self.cpu = cpu

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        top = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = top.id if top is not None else 0
        if top is not None and top.call:
            self.call = top.call
        else:
            self.call = next(_calls) if self.name == "call" else 0
        stack.append(self)
        # the span's own costs (the thread clock, the range a profiler's
        # event) fall inside its interval, not in its parent's self time
        self.t0 = time.time_ns()
        self.c0 = time.thread_time_ns() if self.cpu else None
        self.range = None
        if _ranges and torch._C._autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        cpu = time.thread_time_ns() - self.c0 if self.cpu else None
        t1 = time.time_ns()
        _local.stack.pop()
        rec = Span(self.name, self.t0, t1, cpu, threading.get_ident(), self.id, self.parent,
                   self.call)
        for sink in _sinks:
            sink.append(rec)
        return False


def span(name: str, cpu: bool = False):
    """Context manager naming a stage: while tracing is on, records a
    :class:`Span` (with the thread's CPU time where ``cpu``) and, where
    ranges are asked for and a profiler runs, opens a range of ``name``;
    does nothing otherwise."""
    if not _sinks:
        return _OFF
    return _Open(name, cpu)


def spanned(name: str, cpu: bool = False):
    """Decorator: the function's body inside ``span(name, cpu)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with span(name, cpu):
                return fn(*args, **kwargs)
        return traced
    return wrap


def enabled() -> bool:
    """Whether spans record now."""
    return bool(_sinks)


@contextlib.contextmanager
def tracing(ranges: bool = False):
    """Turn tracing on for the block; yields the list that the spans
    closed inside it are appended to (each block gets every span closed
    while it is open, where blocks nest or overlap).  With ``ranges``,
    spans also open profiler ranges while a profiler runs."""
    global _sinks, _ranges
    records: list = []
    _sinks = _sinks + (records,)
    _ranges += ranges
    try:
        yield records
    finally:
        _sinks = tuple(s for s in _sinks if s is not records)
        _ranges -= ranges


@contextlib.contextmanager
def device_trace(log_dir=TRACE_DIR):
    """Profile the enclosed codec calls with tracing on and write
    ``<log_dir>/trace.json`` (Chrome trace format; open it in Perfetto or
    chrome://tracing): the card's kernels and copies beside the spans'
    ranges.  Yields the profiler; its ``spans`` attribute holds the
    spans' records.  Usage::

        with profiling.device_trace("build/trace") as prof:
            gz.compress(data, 6)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof, tracing(ranges=True) as records:
        prof.spans = records
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))
