"""Event-ordered transfers between the host and a device, for the
compressors' batch path (``de.Batch``) and its dispatch-ahead schedules
(``de._deflate_pipelined`` and the sharded writer's windowed chunks).

On a CUDA device a blocking copy (``.to("cuda")`` of pageable memory,
``.cpu()``, ``bool()`` or ``int()`` of a device tensor) waits for every
piece of work queued on the stream.  With several batches queued ahead,
a blocking read of batch i would wait for the later batches too, and
the look-ahead would fall back to the serial schedule.  So on CUDA:

* :func:`upload` stages a host array in pinned memory and copies it with
  ``non_blocking=True``.  Torch's caching host allocator does not reuse
  the pinned block until the copy has run; a caller that owns a batch
  also keeps the pinned sources (``keep``) until the batch is finished.
* :class:`Fetch` queues ``non_blocking`` copies of some device tensors
  into pinned host memory right behind the work that makes them and
  records one CUDA event after them; :meth:`Fetch.wait` synchronizes on
  that event alone, never on the device or the stream.
* :class:`Queued` is a result dict that carries the Fetch of the entries
  the host will read; :func:`read` takes them from it, or queues a
  Fetch at once for a dict that has none.

Paths that may block (the decode) copy with :func:`put` (a pageable
upload) and :func:`read_now` (a blocking read).

On the CPU nothing is pinned or copied: :func:`upload` is
``torch.from_numpy`` and a Fetch hands back the tensors' own arrays.

Every upload is a ``transfer.upload`` span, every Fetch's queued copies
a ``transfer.fetch`` span, and every wait of the host on the card a
``transfer.wait`` span (``utils.profiling``); :data:`COUNTS` counts the
bytes each way and the waits on a CUDA device.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ..utils import profiling

#: on CUDA devices: bytes uploaded (``uploaded``, from pinned and pageable
#: host memory alike), bytes fetched to the host (``fetched``), and the
#: host's waits on the card (``waits``)
COUNTS: collections.Counter = collections.Counter()


def upload(a: np.ndarray, device: torch.device, keep: list | None = None) -> torch.Tensor:
    """Host array ``a`` as a tensor on ``device``.  On CUDA the copy is
    staged in pinned memory and queued without blocking; the pinned
    source is appended to ``keep`` where one is given."""
    with profiling.span("transfer.upload"):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type != "cuda":
            return t.to(device)
        COUNTS["uploaded"] += t.nbytes
        t = t.pin_memory()
        if keep is not None:
            keep.append(t)
        return t.to(device, non_blocking=True)


def put(a: np.ndarray, device) -> torch.Tensor:
    """Host array ``a`` as a tensor on ``device``, copied from pageable
    memory: on CUDA the copy blocks the host until the stream has run it."""
    with profiling.span("transfer.upload"):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if torch.device(device).type == "cuda":
            COUNTS["uploaded"] += t.nbytes
        return t.to(device)


def read_now(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host at once: a blocking read, which waits for
    everything queued on the stream before it."""
    with profiling.span("transfer.wait"):
        if t.is_cuda:
            COUNTS["fetched"] += t.nbytes
            COUNTS["waits"] += 1
        return t.cpu().numpy()


class Fetch:
    """Host copies of named tensors of one device, queued now.

    On CUDA each tensor is copied ``non_blocking`` into pinned memory on
    the device's current stream, then one event is recorded there; the
    copies are complete, and the pinned arrays valid, only once that
    event has fired, which :meth:`wait` waits for."""

    def __init__(self, tensors: dict[str, torch.Tensor]):
        self.sources = dict(tensors)
        self._event = None
        dev = next(iter(self.sources.values())).device
        if dev.type != "cuda":
            self._host = self.sources
            return
        with profiling.span("transfer.fetch"):
            self._host = {}
            for k, t in self.sources.items():
                self._host[k] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                self._host[k].copy_(t, non_blocking=True)
                COUNTS["fetched"] += t.nbytes
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(dev))

    def holds(self, tensors: dict[str, torch.Tensor]) -> bool:
        """Whether this Fetch copies exactly these tensors under these names."""
        return all(self.sources.get(k) is t for k, t in tensors.items())

    def wait(self, *keys: str) -> list[np.ndarray]:
        """The named tensors on the host, once their copies have run."""
        with profiling.span("transfer.wait"):
            if self._event is not None:
                COUNTS["waits"] += 1
                self._event.synchronize()
            return [self._host[k].numpy() for k in keys]


class Queued(dict):
    """A result dict whose entries ``keys`` are already on their way to
    the host (``fetch``), copied right behind the work that made them."""

    def __init__(self, tensors: dict[str, torch.Tensor], keys):
        super().__init__(tensors)
        self.fetch = Fetch({k: self[k] for k in keys})


def read(res: dict, *keys: str) -> list[np.ndarray]:
    """``res[k]`` on the host for each key: through the Fetch ``res``
    carries where it holds these entries, else through one queued now
    (which waits for everything before it on the stream)."""
    want = {k: res[k] for k in keys}
    fetch = getattr(res, "fetch", None)
    if fetch is None or not fetch.holds(want):
        fetch = Fetch(want)
    return fetch.wait(*keys)
