"""A cell on several cards: one process a card, started here with the
``spawn`` method, each running :func:`harness.measure` on its card with
one client whose calls are collective.  The processes meet through
``torch.distributed`` (gloo) on a free port of ``127.0.0.1``; before each
call the first process broadcasts whether another starts, so all make
the same calls, and a barrier opens the window.  Each sends its report
back over a pipe; the first judges the outputs.  This process prints the
result, with one more check: every process's archive of every call is
the same.
"""

from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import socket
import sys
import time

from benchmark import harness

#: seconds a process may take to send its report, and to end after it
REPORT_TIMEOUT = 900
JOIN_TIMEOUT = 60


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank: int, world: int, port: int, cell: dict, seed: int, seconds: float,
          trace: bool, device: str, entry_maker, conn) -> None:
    import torch
    import torch.distributed as dist

    from decompress_tpu_torch.parallel import multihost

    try:
        multihost.initialize(f"tcp://127.0.0.1:{port}", world, rank)
        dev = f"cuda:{rank}" if device != "cpu" else "cpu"

        def keep_going(t0):
            flag = torch.tensor([int(rank == 0 and harness.now() - t0 < seconds)])
            dist.broadcast(flag, 0)
            return bool(flag.item())

        entry = (entry_maker(cell["config"], cell["traffic"], dev)
                 if entry_maker is not None else None)
        report = harness.measure(cell, seed, seconds, trace, device=dev, entry=entry,
                                 keep_going=keep_going, sync=dist.barrier,
                                 judging=rank == 0)
        conn.send(("ok", report))
    except BaseException as e:
        conn.send(("error", f"process {rank}: {e!r}"))
        raise
    finally:
        conn.close()
        if dist.is_initialized():
            dist.destroy_process_group()


def run(cell: dict, seed: int, seconds: float, trace: bool, *, t_start: float,
        device: str, kind: str, entry_maker=None, out=sys.stdout, err=sys.stderr) -> int:
    """Run a cell on ``cell["chips"]`` cards (or, with ``device="cpu"``,
    as many processes on the host) and print its result line.
    ``entry_maker(config, traffic, device)``, a module-level function,
    stands in for the configuration's entry in every process (the
    tests)."""
    world = cell["chips"]
    if device != "cpu":
        harness.build_program()
    port = free_port()
    ctx = multiprocessing.get_context("spawn")
    procs, conns = [], []
    for rank in range(world):
        recv, send = ctx.Pipe(duplex=False)
        p = ctx.Process(target=_rank, name=f"rank-{rank}",
                        args=(rank, world, port, cell, seed, seconds, trace, device,
                              entry_maker, send))
        p.start()
        send.close()
        procs.append(p)
        conns.append(recv)
    try:
        reports: dict = {}
        deadline = time.monotonic() + REPORT_TIMEOUT
        while len(reports) < world:
            ready = multiprocessing.connection.wait(
                [c for c in conns if conns.index(c) not in reports],
                max(0.0, deadline - time.monotonic()))
            if not ready:
                raise RuntimeError(f"processes sent no report in {REPORT_TIMEOUT} s")
            for conn in ready:
                try:
                    status, report = conn.recv()
                except EOFError:
                    status, report = "error", f"process {conns.index(conn)} ended with no report"
                if status != "ok":
                    raise RuntimeError(report)  # the others are ended below
                reports[conns.index(conn)] = report
        reports = [reports[r] for r in range(world)]
    finally:
        for p in procs:
            p.join(JOIN_TIMEOUT if len(reports) == world else 1)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    checks = dict(reports[0]["checks"])
    first = reports[0]["digests"]
    checks["wrong_across_processes"] = {
        "value": sum(r["digests"] != first for r in reports[1:])
        + sum(a != b for r in reports[1:] for a, b in zip(r["digests"], first)),
        "limit": 0}
    setup_s = harness.setup_seconds(reports[0]["setup_end"], t_start)
    return harness.result(cell, reports, trace, setup_s=setup_s, kind=kind, checks=checks,
                          out=out, err=err)
