"""Arithmetic that the metric files share: rates over the window, span
time per MB, the device's idle share, and kernel time by name in the
traced window.  A reader that finds nothing to read returns None.

The context a reader gets (``harness.measure``): ``calls`` as (input
index, start s, end s, bytes counted, bytes out, digest); ``window_s``,
from the window's start to the end of its last call; ``counted``, the
bytes the rate counts (input bytes of a compression, decoded bytes of a
decode); ``bytes_in``, ``bytes_out``; ``setup_s``; in the traced run
``spans`` ({name: [(start ns, end ns, thread CPU ns)]}) and, on a
card, ``device`` (``trace.device_activity``), ``batches`` and
``kernels``.
"""

from __future__ import annotations

import re
import statistics

#: every kernel of the port's ``csrc``: any other device kernel is a library's
PORT_KERNELS = ("fields_kernel", "probe_kernel", "extend_kernel", "chunk_exit_kernel",
                "chunk_hop_kernel", "chunk_refine_kernel", "hist_kernel",
                "litbits_tally_kernel", "litbits_scan_kernel", "gain_kernel", "slots_kernel",
                "crc_rows_kernel", "inflate_rows_kernel")


def named(name: str, kernels) -> bool:
    """Whether device event ``name`` is one of ``kernels`` (whole words)."""
    return any(re.search(rf"(?<![A-Za-z0-9_]){k}(?![A-Za-z0-9_])", name) for k in kernels)


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def rate_mbps(ctx: dict) -> float:
    """Bytes counted over the window, in MB (10**6 bytes) a second."""
    return ctx["counted"] / 1e6 / ctx["window_s"]


def call_p95_ms(ctx: dict) -> float | None:
    """95th percentile of the calls' wall times, in ms (Python's
    ``statistics.quantiles``, n=20, its last cut)."""
    walls = [1e3 * (end - start) for _, start, end, *_ in ctx["calls"]]
    if len(walls) < 2:
        return None
    return statistics.quantiles(walls, n=20)[-1]


def span_ms_per_mb(ctx: dict, names, cpu: bool) -> float | None:
    """Time inside spans ``names``, summed over every process, per MB
    counted: the calling thread's CPU time where ``cpu``, else wall time."""
    recs = [r for n in names for r in ctx.get("spans", {}).get(n, [])]
    if not recs:
        return None
    ns = sum(r[2] if cpu else r[1] - r[0] for r in recs)
    return ns / 1e6 / (ctx["counted"] / 1e6)


def idle_pct(ctx: dict) -> float | None:
    """Share of the traced window in which no kernel or copy ran, in %."""
    dev = ctx.get("device")
    if dev is None:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])


def kernel_seconds(ctx: dict, pick) -> tuple[float, int]:
    """(seconds, events) of the traced window's device events whose name
    ``pick`` accepts."""
    s, n = 0.0, 0
    for name, (sec, count) in ctx.get("device", {}).get("by_name", {}).items():
        if pick(name):
            s += sec
            n += count
    return s, n
