"""Captured CUDA graphs of the port's device stages: the counterpart of the
reference's ``jax.jit`` cache.

The reference compiles each device stage of compression into one XLA
program, cached by its static arguments and its inputs' shapes and
dtypes, and runs a batch's stage as one dispatch.  Eager torch runs the
same stage as hundreds of launches, each paying the host's enqueue.
:func:`program` wraps such a stage so that on a CUDA device it runs as
one replay of a ``torch.cuda.CUDAGraph``:

* **Key.**  The function, the values of its static arguments, and each
  tensor argument's shape, dtype and device, with the structure of the
  arguments (which optional ones are ``None``).  Strides are not part of
  it: inputs are copied into contiguous static tensors.
* **First call of a key.**  The function runs eagerly on a side stream
  (its result is the call's result; the run also makes the kernels'
  first-call settings, such as a shared-memory opt-in, outside any
  capture), then is captured into static inputs with
  ``torch.cuda.graph`` on the arguments' device.  A capture that fails
  raises: nothing falls back to eager execution.
* **Every later call.**  Each input is copied into its static tensor,
  the graph replays on the current stream, and the call returns clones
  of the static outputs in the function's structure.  Clones, because
  the dispatch-ahead schedules keep several batches of one key in flight
  (``de._deflate_pipelined``, the sharded writer's windowed chunks): the
  next replay overwrites the static outputs while an earlier batch's
  round B, pack or host read still uses its own.  A replay waits on the
  stream for the key's previous replay (an event recorded after its
  clones), so callers on other streams cannot copy into the static
  inputs, or run the graph on its buffers, under a replay still running.
* **Launch counts.**  A replay runs no wrapper, so the capture's delta of
  ``_build.LAUNCHES`` is taken back out after the capture (a capture
  executes nothing) and added again on every replay; :data:`REPLAYS`
  counts the replays themselves.
* **Span.**  A call from outside every program (on the CPU too, where
  it runs the function) is one ``programs.dispatch`` span
  (``utils.profiling``): the key, the lookup and the replay.
* **Cache.**  The captured programs of each device form an LRU of at
  most :data:`MAX_PROGRAMS` entries.

On the CPU, and inside another program's run or capture (as a nested
``jax.jit`` is traced into its caller), a program is its function.
:meth:`Program.eager` runs the function eagerly, for measurement.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import inspect
import threading
import time

import torch

from .. import _build
from ..utils import profiling

#: captured programs kept per device, the least recently used evicted
#: first: every path of one process needs 25 (PERF.md), and a round-A
#: graph pool at the production batch holds ~400 MiB
MAX_PROGRAMS = 32

#: captures by program name
CAPTURES: collections.Counter = collections.Counter()
#: replays by program name
REPLAYS: collections.Counter = collections.Counter()

_cache: dict[int, collections.OrderedDict] = {}
_lock = threading.RLock()
_local = threading.local()


def _flatten(obj, leaves: list, what: str):
    """The structure of ``obj`` (tensors, None, dicts, tuples, lists) as a
    hashable spec; its tensors appended to ``leaves`` in order."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return "T"
    if obj is None:
        return None
    if isinstance(obj, dict):
        return ("dict", tuple((k, _flatten(v, leaves, what)) for k, v in obj.items()))
    if isinstance(obj, (tuple, list)):
        return (type(obj).__name__, tuple(_flatten(v, leaves, what) for v in obj))
    raise TypeError(f"{what}: a {type(obj).__name__} is neither a tensor nor a "
                    f"structure of tensors; declare the argument static")


def _unflatten(spec, leaves):
    """Inverse of :func:`_flatten` over an iterator of tensors."""
    if spec == "T":
        return next(leaves)
    if spec is None:
        return None
    kind, items = spec
    if kind == "dict":
        return {k: _unflatten(s, leaves) for k, s in items}
    vals = [_unflatten(s, leaves) for s in items]
    return tuple(vals) if kind == "tuple" else vals


@contextlib.contextmanager
def _inside():
    """Mark this thread as running a program's function (nested programs
    then run as their functions)."""
    _local.depth = getattr(_local, "depth", 0) + 1
    try:
        yield
    finally:
        _local.depth -= 1


@dataclasses.dataclass
class Captured:
    """One captured program: its graph, static inputs and outputs, the
    launches a replay stands for, and what the capture cost."""

    name: str
    key: tuple
    graph: torch.cuda.CUDAGraph
    inputs: list
    outputs: list
    spec: object
    launches: collections.Counter
    capture_s: float
    pool_bytes: int
    #: recorded after each replay's clones, on that replay's stream
    done: torch.cuda.Event = dataclasses.field(default_factory=torch.cuda.Event)

    def replay(self, leaves: list):
        stream = torch.cuda.current_stream()
        stream.wait_event(self.done)  # the key's previous replay, on any stream
        for static, x in zip(self.inputs, leaves):
            static.copy_(x)
        self.graph.replay()
        REPLAYS[self.name] += 1
        _build.LAUNCHES.update(self.launches)
        out = _unflatten(self.spec, iter([o.clone() for o in self.outputs]))
        self.done.record(stream)
        return out


class Program:
    """A device stage run as a captured CUDA graph on a CUDA device; see
    the module docstring.  ``static`` names the arguments that are part
    of the key by value; every other argument is a tensor, ``None`` or a
    structure of tensors."""

    def __init__(self, fn, static=()):
        functools.update_wrapper(self, fn)  # the function is __wrapped__
        self.static = frozenset(static)
        self._sig = inspect.signature(fn)
        unknown = self.static - set(self._sig.parameters)
        if unknown:
            raise ValueError(f"{fn.__qualname__}: no arguments {sorted(unknown)}")

    def key(self, *args, **kwargs):
        """(key, tensor leaves, bound arguments) of a call."""
        bound = self._sig.bind(*args, **kwargs)
        bound.apply_defaults()
        statics, leaves, spec = [], [], []
        for name, value in bound.arguments.items():
            if name in self.static:
                statics.append((name, value))
            else:
                spec.append((name, _flatten(value, leaves, f"{self.__qualname__}({name})")))
        shapes = tuple((tuple(t.shape), t.dtype, t.device.type, t.device.index)
                       for t in leaves)
        return (self.__wrapped__, tuple(statics), tuple(spec), shapes), leaves, bound

    def eager(self, *args, **kwargs):
        """The function run eagerly, with the programs it calls run as
        their functions too (for measurement)."""
        with _inside():
            return self.__wrapped__(*args, **kwargs)

    def __call__(self, *args, **kwargs):
        if getattr(_local, "depth", 0):
            return self.__wrapped__(*args, **kwargs)
        with profiling.span("programs.dispatch"):
            return self._dispatch(args, kwargs)

    def _dispatch(self, args, kwargs):
        key, leaves, bound = self.key(*args, **kwargs)
        devices = {t.device for t in leaves}
        if not any(d.type == "cuda" for d in devices):
            return self.__wrapped__(*args, **kwargs)
        if len(devices) > 1:
            raise ValueError(f"{self.__qualname__}: tensors on {sorted(map(str, devices))}")
        dev = devices.pop()
        with _lock, torch.cuda.device(dev):
            programs = _cache.setdefault(dev.index, collections.OrderedDict())
            entry = programs.get(key)
            if entry is not None:
                programs.move_to_end(key)
                return entry.replay(leaves)
            out, programs[key] = self._capture(dev, key, leaves, bound)
            while len(programs) > MAX_PROGRAMS:
                programs.popitem(last=False)
            return out

    def _call_with(self, bound, leaves):
        """The function on ``bound``'s arguments with its tensors replaced
        by ``leaves``, in order."""
        it = iter(leaves)
        args = {name: value if name in self.static else
                _unflatten(_flatten(value, [], ""), it)
                for name, value in bound.arguments.items()}
        call = self._sig.bind_partial()
        call.arguments.update(args)
        return self.eager(*call.args, **call.kwargs)

    def _capture(self, dev, key, leaves, bound):
        """The eager result of the first call of a key, and its capture."""
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self._call_with(bound, leaves)
        current.wait_stream(side)
        out_leaves: list = []
        _flatten(out, out_leaves, f"{self.__qualname__} result")
        for t in leaves:
            t.record_stream(side)
        for t in out_leaves:
            t.record_stream(current)

        t0 = time.perf_counter()
        inputs = [torch.empty(t.shape, dtype=t.dtype, device=dev).copy_(t) for t in leaves]
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = collections.Counter(_build.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        # the outer stream context puts the caller's stream back even where
        # a failed capture leaves torch.cuda.graph's own stream current
        with torch.cuda.stream(current), torch.cuda.graph(graph):
            static_out = self._call_with(bound, inputs)
        launches = _build.LAUNCHES - before
        _build.LAUNCHES.subtract(launches)
        outputs: list = []
        spec = _flatten(static_out, outputs, f"{self.__qualname__} result")
        CAPTURES[self.__qualname__] += 1
        return out, Captured(self.__qualname__, key, graph, inputs, outputs, spec, launches,
                             time.perf_counter() - t0,
                             torch.cuda.memory_reserved(dev) - reserved)


def program(*, static=()):
    """Decorator: the function as a :class:`Program` with these static
    arguments."""
    return functools.partial(Program, static=static)


def captured(device=None) -> list[Captured]:
    """The captured programs of a CUDA device (default: the current one),
    least recently used first."""
    index = torch.device(device if device is not None else "cuda").index
    if index is None:
        index = torch.cuda.current_device()
    return list(_cache.get(index, {}).values())


def clear() -> None:
    """Drop every captured program (their graphs and memory pools)."""
    with _lock:
        _cache.clear()
