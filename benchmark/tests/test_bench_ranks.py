"""A cell on four cards (the archive written by four processes, from
``configs/calgary-archive6-4proc.json`` and ``traffic/ranks4-64m.json``),
rehearsed on the CPU: four processes meet over gloo and write one
archive a call; with the exchange left out, or one process's answer
altered, the run comes out not correct."""

import io
import json
import time

import pytest

from benchmark import ranks, spec
from benchmark.entries import archive_multihost

NAME = "archive6-calgary-64m-4proc"
MEMBER = 40_000


def small_cell():
    return {
        "name": NAME, "chips": 4,
        "config": dict(spec.load_json(spec.HERE / "configs" / "calgary-archive6-4proc.json"),
                       member_size=MEMBER),
        "traffic": dict(spec.load_json(spec.HERE / "traffic" / "ranks4-64m.json"),
                        input_bytes=8 * MEMBER - 1234, inputs=1),
        "end_to_end": [{"name": n} for n in ("compress_MBps", "ratio", "setup_s")],
        "per_layer": [{"name": n} for n in (
            "call_p95_ms.compress", "plan_blocks_ms_per_MB.compress", "gather_ms_per_MB.compress")],
    }


class NoExchange(archive_multihost.Entry):
    """Each process returns the archive of its own members: the exchange
    between processes left out."""

    def call(self, payload):
        import numpy as np
        import torch.distributed as dist

        total = -(-payload.size // self.member_size)
        per = -(-total // dist.get_world_size())
        lo = dist.get_rank() * per * self.member_size
        local = np.ascontiguousarray(payload[lo:lo + per * self.member_size])
        return self._sharded.sharded_gzip_compress(local, self.level,
                                                   member_size=self.member_size,
                                                   device=self.device)


class AlteredOnOne(archive_multihost.Entry):
    """The last process's archive altered where it is produced."""

    def call(self, payload):
        import torch.distributed as dist

        out = super().call(payload)
        if dist.get_rank() == dist.get_world_size() - 1:
            out = bytearray(out)
            out[len(out) // 2] ^= 0x10
            out = bytes(out)
        return out


def no_exchange(config, traffic, device):
    return NoExchange(config, traffic, device)


def altered_on_one(config, traffic, device):
    return AlteredOnOne(config, traffic, device)


def run(entry_maker=None, trace=False):
    out = io.StringIO()
    rc = ranks.run(small_cell(), 77, 0.5, trace, t_start=time.perf_counter(), device="cpu",
                   kind="cpu", entry_maker=entry_maker, out=out, err=io.StringIO())
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_four_processes_write_one_archive():
    res = run(trace=True)
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["wrong_across_processes"]["value"] == 0
    assert res["metrics"]["gather_ms_per_MB.compress"]["value"] > 0


@pytest.mark.parametrize("maker", [no_exchange, altered_on_one])
def test_fault_is_not_correct(maker):
    res = run(maker)
    assert res["correct"] is False


class FailsOnOne(archive_multihost.Entry):
    def call(self, payload):
        import torch.distributed as dist

        if dist.get_rank() == 2:
            raise RuntimeError("planted failure")
        return super().call(payload)


def fails_on_one(config, traffic, device):
    return FailsOnOne(config, traffic, device)


def test_a_lost_process_fails_the_run_at_once():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="planted failure"):
        run(fails_on_one)
    assert time.monotonic() - t0 < 120
