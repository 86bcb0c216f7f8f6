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

The pieces are host bytes, so the collectives are gloo all-gathers of CPU
tensors (NCCL would also refuse two ranks on one card).  One process
degenerates to the single-process archive.
"""

from __future__ import annotations

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


@profiling.spanned("processes.gather")
def _all_gather(x: np.ndarray) -> np.ndarray:
    """``x`` from every process, stacked by process index: [P, *x.shape]."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


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
    all_sizes = _all_gather(np.array([len(local_arch)], np.int64))
    cap = int(all_sizes.max())
    buf = np.zeros(cap, np.uint8)
    buf[: len(local_arch)] = np.frombuffer(local_arch, np.uint8)
    gathered = _all_gather(buf)
    archive = b"".join(gathered[p, : int(all_sizes[p, 0])].tobytes()
                       for p in range(nproc))  # by process == by member range

    # per-member metadata, to rebuild the single-process FEXTRA index
    per = -(-total // nproc)
    width = 2 + 3 * (sharded.N_SPLITS - 1)
    meta = np.zeros((per, width), np.int64)
    for j, s in enumerate(local_sizes):
        meta[j, 0] = s
        meta[j, 1] = local_ncmds[j]
        meta[j, 2:] = [v for tri in local_splits[j] for v in tri]
    all_meta = _all_gather(meta)  # [P, per, width]
    sizes, split_rows, ncmds = [], [], []
    for p in range(nproc):
        plo = min(p * per, total)
        phi = min(plo + per, total)
        for j in range(phi - plo):
            sizes.append(int(all_meta[p, j, 0]))
            ncmds.append(int(all_meta[p, j, 1]))
            row = all_meta[p, j, 2:].reshape(-1, 3)
            split_rows.append([tuple(int(v) for v in t) for t in row])
    xt = sharded._build_index(total, sizes, split_rows, ncmds)
    if xt is not None:
        head0 = bytearray(archive[:10])
        head0[3] |= _FEXTRA
        archive = bytes(head0) + xt + archive[10:]
    return archive
