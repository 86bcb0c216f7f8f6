"""One run of one cell: set-up, the measured window, the check and the
result line.

A process drives one card with one client.  Its loop is closed: it
starts its next call when its last one has returned, cycling its inputs,
and starts none once ``seconds`` have passed since the window opened; it
finishes the call it is in.  The window ends when that call ends.  A
cell on several cards runs one such process a card (``benchmark.ranks``),
whose calls are collective: the first process decides for all whether
another call starts.

Set-up (``setup_s``, from the process's start until the window opens):
the inputs, made from the seed; the program's kernels, built at first
use; every input's payload; every input run once, so that each captured
program a call needs is captured before the window.  A call that
captures a program inside the window fails the run.

After the window, :mod:`benchmark.reference` judges every distinct
output (the calls on one input give one output unless the program is at
fault, and a second output is judged too).
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import json
import sys
import time

import numpy as np

from benchmark import inputs, spec
from benchmark import trace as tracing

#: top-level module names that may not be loaded when the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "decompress_tpu")

#: the window's clock (seconds); the tests put a fake one here
now = time.perf_counter


def check_device(device: str, chips: int) -> str:
    """The card's name; exits without the cards the cell asks for."""
    import torch

    if device == "cpu":
        return "cpu"
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: the benchmark runs only on a card")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell asks for {chips} cards, and "
                         f"{torch.cuda.device_count()} are present")
    return torch.cuda.get_device_name(0)


def build_program() -> None:
    """The program's kernels and host library, built here at first use
    (inside the checkout) so that no call builds them."""
    from decompress_tpu_torch import _build, native

    _build.build()
    native.build()


def _program_counters() -> dict:
    """Captured programs, their pools' bytes, and the captures so far."""
    from decompress_tpu_torch.ops import graphs

    progs = graphs.captured()
    return {"programs": len(progs), "pool_bytes": sum(p.pool_bytes for p in progs),
            "captures": sum(graphs.CAPTURES.values())}


@contextlib.contextmanager
def _counting_replays():
    """Count replays of captured programs inside the block, by program."""
    from decompress_tpu_torch.ops import graphs

    counts: collections.Counter = collections.Counter()
    replay = graphs.Captured.replay

    def counted(self, leaves):
        counts[self.name] += 1
        return replay(self, leaves)

    graphs.Captured.replay = counted
    try:
        yield counts
    finally:
        graphs.Captured.replay = replay


def metric_modules(cell: dict, trace: bool) -> dict:
    return {m["name"]: spec.load_module("metrics", m["name"])
            for m in (cell["per_layer"] if trace else cell["end_to_end"])}


def measure(cell: dict, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
            entry=None, keep_going=None, sync=None, judging: bool = True,
            err=sys.stderr) -> dict:
    """Set up, run the window and judge on ``device`` in this process.
    Returns the process's report: what the metrics read (``ctx``), the
    checks, the device's numbers, each call's digest, and the window's
    start (``setup_end``, ns on the epoch clock).  ``entry`` stands in for
    the configuration's entry (the tests' controls and faults);
    ``keep_going(t0)`` decides whether a call starts and ``sync()`` runs
    just before the window opens (the processes of a cell on several
    cards decide and start together); without ``judging`` the outputs go
    unjudged (a process whose outputs another judges)."""
    config, traffic = cell["config"], cell["traffic"]
    import torch

    torch.set_num_threads(traffic["host_threads"])
    dev = torch.device(device) if device != "cpu" else None
    if dev is not None:
        torch.cuda.set_device(dev)
    if entry is None:
        entry = spec.load_module("entries", config["entry"]).make(config, traffic, device)
    if keep_going is None:
        def keep_going(t0):
            return now() - t0 < seconds
    data = inputs.make_inputs(config["corpus"], traffic["input_bytes"], seed,
                              traffic["inputs"])
    payloads = [entry.prepare(x) for x in data]
    for p in payloads:  # every program a call needs is captured here
        entry.call(p)

    spans = tracing.Spans({name: paths for mod in metric_modules(cell, trace).values()
                           for name, paths in getattr(mod, "SPANS", {}).items()})
    if dev is not None:
        torch.cuda.synchronize(dev)
        before = _program_counters()
    counters0 = entry.counters()
    if sync is not None:
        sync()
    #: (input index, start s, end s, bytes counted, bytes out, digest)
    calls: list = []
    outputs: dict = {}  # (input index, digest) -> output
    with contextlib.ExitStack() as stack:
        if trace:
            stack.callback(spans.remove)
            spans.install()
            if dev is not None:
                replays = stack.enter_context(_counting_replays())
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev is not None else [])
            prof = stack.enter_context(profile(activities=acts))
        t0_ns = time.time_ns()
        t0 = now()
        j = 0
        while keep_going(t0):
            k = j % len(payloads)
            start = now()
            out = entry.call(payloads[k])
            end = now()
            digest = hashlib.sha256(out).digest()
            outputs.setdefault((k, digest), out)
            counted = len(out) if entry.kind == "decompress" else len(payloads[k])
            calls.append((k, start, end, counted, len(out), digest))
            j += 1
        if dev is not None:
            torch.cuda.synchronize(dev)
        t1_ns = time.time_ns()
    if not calls:
        raise RuntimeError("no call finished in the window")
    t_end = calls[-1][2]
    walls = sorted(1e3 * (c[2] - c[1]) for c in calls)
    print(f"calls {len(calls)}: ms p10 {walls[len(walls) // 10]:.1f} median "
          f"{walls[len(walls) // 2]:.1f} p90 {walls[9 * len(walls) // 10]:.1f} max "
          f"{walls[-1]:.1f}; window {t_end - t0:.3f} s", file=err)
    delta = {k: v - counters0[k] for k, v in entry.counters().items()}

    sizes = [len(x) for x in data]
    ctx = {"kind": entry.kind, "calls": calls, "window_s": t_end - t0,
           "bytes_in": sum(sizes[k] for k, *_ in calls),
           "bytes_out": sum(x[4] for x in calls), "counted": sum(x[3] for x in calls),
           "batches": [b for k, *_ in calls for b in entry.batches(sizes[k])],
           "kernels": entry.kernels, "level": config.get("level")}
    report = {"ctx": ctx, "setup_end": t0_ns, "delta": delta,
              "digests": [x[-1] for x in calls]}
    if dev is not None:
        report["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
        after = _program_counters()
        if after["captures"] != before["captures"]:
            raise RuntimeError(f"{after['captures'] - before['captures']} programs were "
                               "captured inside the window: set-up did not warm every shape")
    if trace:
        silent = spans.silent()
        if silent:
            raise RuntimeError(f"spans saw no call in the traced window: {silent}")
        ctx["spans"] = spans.records
        if dev is not None:
            activity = tracing.device_activity(tracing.device_events(prof), t0_ns, t1_ns)
            if activity["busy_s"] <= 0:
                raise RuntimeError("the profile holds no device activity in the window")
            ctx["device"] = activity
            print(f"trace: {activity['events']} device events, graph replays "
                  f"{sum(replays.values())}, captured programs {after['programs']}, "
                  f"pool bytes {after['pool_bytes']}", file=err)
        print(f"trace: counters in the window {json.dumps(delta)}", file=err)

    del payloads
    if dev is not None:
        torch.cuda.empty_cache()
    checks = judge(entry, data, outputs, seed, err) if judging else {}
    checks.update({k: {"value": v, "limit": 0} for k, v in entry.window_checks(delta).items()})
    report["checks"] = checks
    return report


def judge(entry, data: list, outputs: dict, seed: int, err=sys.stderr) -> dict:
    """Every distinct output of the window (``outputs``: {(input index,
    digest): bytes}) judged by the reference against ``data[index]``: the
    faults by kind, summed, each with its limit 0."""
    rng = np.random.default_rng((seed % (1 << 64), 1 << 20))
    faults: dict = {}
    t = time.perf_counter()
    for (k, _digest), out in sorted(outputs.items()):
        for name, n in entry.judge(data[k], out, rng).items():
            faults[name] = faults.get(name, 0) + n
    print(f"judged {len(outputs)} distinct outputs in {time.perf_counter() - t:.1f} s",
          file=err)
    return {f"wrong_{k}": {"value": v, "limit": 0} for k, v in faults.items()}


def merge(reports: list) -> dict:
    """The context the metrics read, over every card's report: the first
    card's calls and window (the calls are collective), every card's
    spans and batches, and the device's activity averaged over the cards
    (busy and window) or summed (time and launches by name)."""
    ctx = dict(reports[0]["ctx"])
    if len(reports) == 1:
        return ctx
    ctx["batches"] = [b for r in reports for b in r["ctx"]["batches"]]
    if "spans" in ctx:
        ctx["spans"] = {name: [rec for r in reports for rec in r["ctx"]["spans"][name]]
                        for name in ctx["spans"]}
    if "device" in ctx:
        acts = [r["ctx"]["device"] for r in reports]
        by_name: dict = collections.defaultdict(lambda: [0.0, 0])
        for a in acts:
            for name, (s, n) in a["by_name"].items():
                by_name[name][0] += s
                by_name[name][1] += n
        ctx["device"] = dict(acts[0], by_name=dict(by_name),
                             busy_s=sum(a["busy_s"] for a in acts) / len(acts),
                             window_s=sum(a["window_s"] for a in acts) / len(acts))
    return ctx


def result(cell: dict, reports: list, trace: bool, *, setup_s: float, kind: str,
           checks: dict, out=sys.stdout, err=sys.stderr) -> int:
    """Print the result line of a run from its cards' reports; returns the
    exit code (3, and no result, where a forbidden module is loaded)."""
    ctx = merge(reports)
    ctx["setup_s"] = setup_s
    metrics = {}
    for name, mod in metric_modules(cell, trace).items():
        value = mod.read(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": mod.UNIT}
    device = {"platform": "gpu" if kind != "cpu" else "cpu", "kind": kind,
              "count": cell["chips"]}
    if "memory_peak_bytes" in reports[0]:
        device["memory_peak_bytes"] = max(r["memory_peak_bytes"] for r in reports)
    res = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": len(ctx["calls"]), "failed": 0, "metrics": metrics, "device": device}
    if "device" in ctx:
        device["busy_s"] = ctx["device"]["busy_s"]
        device["window_s"] = ctx["device"]["window_s"]
        res["breakdown"] = breakdown(ctx["device"], ctx["spans"])
    res["checks"] = checks
    loaded = forbidden_loaded(sys.modules)
    if loaded:
        print(f"forbidden modules loaded in the run: {loaded}", file=err)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=err)
    err.flush()
    print(json.dumps(res), file=out, flush=True)
    return 0


def forbidden_loaded(modules) -> list[str]:
    """The forbidden top-level names among module names ``modules``,
    each compared whole (the part before the first dot), so
    ``decompress_tpu_torch`` is not ``decompress_tpu``."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def breakdown(activity: dict, spans: dict) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the span that covers it most."""
    ops = sorted(activity["by_name"].items(), key=lambda kv: -kv[1][0])[:10]
    return {"device_ops": [[n[:80], s] for n, (s, _) in ops],
            "idle_gaps": [[tracing.label_gap(g, spans), (g[1] - g[0]) / 1e9]
                          for g in activity["gaps"][:10]]}


def setup_seconds(setup_end_ns: int, t_start: float) -> float:
    """From ``t_start`` (``time.perf_counter``) to the window's start
    (``setup_end_ns``, ns on the epoch clock)."""
    return (setup_end_ns - time.time_ns()) / 1e9 + time.perf_counter() - t_start


def run(cell: dict, seed: int, seconds: float, trace: bool, *, t_start: float,
        device: str = "cuda", entry=None, out=sys.stdout, err=sys.stderr) -> int:
    """Run ``cell`` (``spec.load_cell``) once on its cards, or with
    ``device="cpu"`` on the host (the tests), and print its result line;
    returns the exit code.  ``t_start`` is the process's start on
    ``time.perf_counter``'s clock."""
    kind = check_device(device, cell["chips"])
    if cell["chips"] > 1:
        from benchmark import ranks

        return ranks.run(cell, seed, seconds, trace, t_start=t_start, device=device,
                         kind=kind, out=out, err=err)
    if device != "cpu":
        build_program()
        device = "cuda:0"
    report = measure(cell, seed, seconds, trace, device=device, entry=entry, err=err)
    return result(cell, [report], trace, setup_s=setup_seconds(report["setup_end"], t_start),
                  kind=kind, checks=report["checks"], out=out, err=err)
