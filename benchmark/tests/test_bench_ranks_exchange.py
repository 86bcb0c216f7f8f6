"""The four-card cell's exchange metrics, rehearsed on the CPU (the small
cell of ``test_bench_ranks.py``): the wait for the slowest process, the
all-gathers and the index rebuild all read, the wait inside the
all-gathers; a process that starts each call 0.2 s late shows in the
others' wait; and the cell as ``BENCHMARK.json`` declares it lists no
metric that reads the program's own spans, which stay in the processes
that record them."""

import ast
import io
import json
import time

from benchmark import ranks, spec
from benchmark.entries import archive_multihost
from benchmark.tests.test_bench_ranks import MEMBER, NAME, small_cell

EXCHANGE = ("gather_ms_per_MB.compress", "rank_wait_ms_per_MB.compress",
            "exchange_index_ms_per_MB.compress")
LATE_S = 0.2


class LateOnRankTwo(archive_multihost.Entry):
    """Process 2 starts each call ``LATE_S`` after the others."""

    def call(self, payload):
        import torch.distributed as dist

        if dist.get_rank() == 2:
            time.sleep(LATE_S)
        return super().call(payload)


def late_on_rank_two(config, traffic, device):
    return LateOnRankTwo(config, traffic, device)


def run_traced(entry_maker=None, seconds: float = 0.5, member: int = MEMBER) -> dict:
    """A traced run of the small cell, its members of ``member`` bytes."""
    small = small_cell()
    config = dict(small["config"], member_size=member)
    traffic = dict(small["traffic"], input_bytes=8 * member - 1234)
    cell = dict(small, config=config, traffic=traffic,
                per_layer=[{"name": n} for n in EXCHANGE])
    out = io.StringIO()
    rc = ranks.run(cell, 78, seconds, True, t_start=time.perf_counter(), device="cpu",
                   kind="cpu", entry_maker=entry_maker, out=out, err=io.StringIO())
    assert rc == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    res["MB_a_call"] = traffic["input_bytes"] / 1e6
    return res


def test_exchange_metrics_read():
    metrics = run_traced()["metrics"]
    got = {n: metrics[n]["value"] for n in EXCHANGE}
    assert all(v > 0 for v in got.values()), got
    assert got["rank_wait_ms_per_MB.compress"] <= got["gather_ms_per_MB.compress"], got


def test_a_late_process_shows_in_the_others_wait():
    # small members, and several calls a window: the processes start the
    # window's first call as their profilers come up, apart by up to ~0.4 s
    on_time, late = (run_traced(maker, seconds=4.0, member=4096)
                     for maker in (None, late_on_rank_two))
    name = "rank_wait_ms_per_MB.compress"
    waits = [r["metrics"][name]["value"] * r["MB_a_call"] for r in (on_time, late)]
    # three processes wait about LATE_S a call each, summed; the late
    # process's sleep also hides the others' own spread of a call's time,
    # which on a shared host is 0.03-0.25 s a call summed, so the late
    # run's wait is held to the floor, not its rise over the on-time run
    assert waits[1] >= 3 * 0.75 * LATE_S * 1e3 and waits[1] > waits[0], waits


def _imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom):
            names.update(f"{node.module}.{a.name}" for a in node.names)
        elif isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
    return names


def test_the_four_card_cell_lists_no_metric_of_the_program_spans():
    cell = spec.load_cell(NAME)
    assert cell["chips"] == 4
    listed = [m["name"] for m in cell["per_layer"]]
    assert set(EXCHANGE) <= set(listed)
    for name in listed + [m["name"] for m in cell["end_to_end"]]:
        path = spec.HERE / "metrics" / f"{name}.py"
        assert "benchmark.program_spans" not in _imports(path), name
