"""The multi-process archive on ``torch.distributed`` (counterpart of
``decompress_tpu/parallel/multihost.py``).

* :func:`initialize` brings up the process group (gloo): the same
  program runs in every process, each with its rank.
* :func:`sharded_gzip_compress_multihost` has each process compress the
  members of its block of the input (on its device or mesh, through
  ``sharded.sharded_gzip_compress``), then exchanges the archive pieces'
  sizes, the pieces and the per-member metadata with all-gathers and
  assembles the archive by process index, which is member order, with
  the same FEXTRA index the single-process writer builds: every process
  gets the single-process archive, byte for byte.

The exchange is traced by its parts (``utils.profiling``): the sizes'
all-gather, the first collective of a call, is ``processes.wait`` (it
moves 8 bytes, so its time is this process's wait for the slowest); the
pieces' and the metadata's all-gathers are ``processes.gather``; the
index rebuilt from every process's metadata (one int64 array from the
gather to the index bytes) is ``processes.index``.
:data:`COUNTS` counts the collectives and the bytes each way.  The steps
are module functions called through their module names, so that a
wrapper set on the module sees every call.

The pieces are host bytes, so the collectives are gloo all-gathers of CPU
tensors (NCCL would also refuse two ranks on one card).  One process
degenerates to the single-process archive.
"""

from __future__ import annotations

import collections
import os

import numpy as np
import torch
import torch.distributed as dist

from .. import de
from ..gz import _FEXTRA
from ..utils import profiling
from . import sharded

#: environment variables a launcher (torchrun) sets for ``env://``
_LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")

#: the exchange's all-gathers (``collectives``), the bytes this process
#: sent in them (``sent``) and the bytes it received from the others
#: (``received``), the pieces' padding included
COUNTS: collections.Counter = collections.Counter()


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up the gloo process group (idempotent).

    ``coordinator_address`` is a ``torch.distributed`` init method
    (``tcp://host:port``, ``file:///path``) or a bare ``host:port``; with
    it, ``num_processes`` and ``process_id`` are the world size and this
    process's rank, and a failed bring-up raises.  With no address the
    group comes up from a launcher's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) where one is set, and
    otherwise stays single-process."""
    if dist.is_initialized():
        return
    if coordinator_address is None:
        if not all(k in os.environ for k in _LAUNCHER_ENV):
            return  # single process: nothing to bring up
        dist.init_process_group("gloo", init_method="env://")
        return
    if "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    dist.init_process_group("gloo", init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)


def _world() -> tuple[int, int]:
    """(process count, this process's index); (1, 0) with no group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _local_member_range(total_members: int) -> tuple[int, int]:
    """Contiguous member range owned by this process (block layout)."""
    p, i = _world()
    per = -(-total_members // p)
    lo = min(i * per, total_members)
    hi = min(lo + per, total_members)
    return lo, hi


def _all_gather(x: np.ndarray, span: str = "processes.gather") -> np.ndarray:
    """``x`` from every process, stacked by process index: [P, *x.shape],
    inside span ``span``."""
    with profiling.span(span):
        t = torch.from_numpy(np.ascontiguousarray(x))
        out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(out, t)
        COUNTS.update(collectives=1, sent=t.nbytes, received=t.nbytes * (len(out) - 1))
        return torch.stack(out).numpy()


def _gather_sizes(n: int) -> np.ndarray:
    """Every process's piece size ``n``, by process index: [P].  The
    first collective of a call, so its time is this process's wait for
    the slowest."""
    return _all_gather(np.array([n], np.int64), "processes.wait")[:, 0]


def sharded_gzip_compress_multihost(data, level: int = 6, *,
                                    member_size: int = de.SEGMENT_SIZE, mesh=None,
                                    device="cuda") -> bytes:
    """The whole archive, compressed across all processes.

    ``data`` is the full input in every process (the member range each
    compresses is a pure function of its rank).  Returns the complete
    archive in every process, byte-identical everywhere and to
    ``sharded_gzip_compress(data, level, member_size=member_size)``.
    Each process compresses on ``device``, or over ``mesh`` where one is
    given.  A failed collective raises; nothing falls back to a
    single-process archive."""
    sharded._mesh_devices(mesh, device)  # raises without the device
    arr = de._np_u8(data)
    with profiling.span("call"):
        nproc, _ = _world()
        if arr.size == 0 or nproc == 1:
            return sharded.sharded_gzip_compress(arr, level, member_size=member_size,
                                                 mesh=mesh, device=device)
        total = max(1, (arr.size + member_size - 1) // member_size)
        lo, hi = _local_member_range(total)
        local = arr[lo * member_size : hi * member_size]
        if local.size:
            meta = sharded.sharded_gzip_compress(
                local, level, member_size=member_size, mesh=mesh, index=False,
                return_meta=True, device=device)
        else:
            meta = b"", [], [], []
        return _exchange(total, nproc, *meta)


@profiling.spanned("schedule.assemble")
def _exchange(total: int, nproc: int, local_arch: bytes, local_sizes: list,
              local_splits: list, local_ncmds: list) -> bytes:
    """The whole archive from this process's piece of ``total`` members
    and its per-member meta, exchanged with the other processes."""
    # order-preserving gather: sizes first, then the pieces padded to the
    # largest, by process index
    all_sizes = _gather_sizes(len(local_arch))
    cap = int(all_sizes.max())
    buf = np.zeros(cap, np.uint8)
    buf[: len(local_arch)] = np.frombuffer(local_arch, np.uint8)
    gathered = _all_gather(buf)
    archive = b"".join(gathered[p, : int(all_sizes[p])].tobytes()
                       for p in range(nproc))  # by process == by member range

    # per-member metadata, to rebuild the single-process FEXTRA index
    per = -(-total // nproc)
    width = 2 + 3 * (sharded.N_SPLITS - 1)
    meta = np.zeros((per, width), np.int64)
    n = len(local_sizes)
    if n:
        meta[:n, 0] = local_sizes
        meta[:n, 1] = local_ncmds
        meta[:n, 2:] = np.asarray(local_splits, np.int64).reshape(n, -1)
    return _assemble_index(archive, total, _all_gather(meta))  # [P, per, width]


@profiling.spanned("processes.index")
def _assemble_index(archive: bytes, total: int, all_meta: np.ndarray) -> bytes:
    """``archive`` with the FEXTRA index of its ``total`` members, rebuilt
    from every process's metadata rows (``all_meta``: [P, per, width], by
    process index, each process's members in its first rows)."""
    nproc, per = all_meta.shape[:2]
    rows = np.concatenate([all_meta[p, : max(0, min(per, total - p * per))]
                           for p in range(nproc)])  # [total, width], member order
    xt = sharded._build_index(total, rows[:, 0], rows[:, 2:].reshape(total, -1, 3),
                              rows[:, 1])
    if xt is not None:
        head0 = bytearray(archive[:10])
        head0[3] |= _FEXTRA
        archive = b"".join((head0, xt, memoryview(archive)[10:]))  # one copy
    return archive
