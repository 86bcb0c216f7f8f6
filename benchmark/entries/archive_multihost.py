"""The indexed archive written by several processes: a call is
``parallel.multihost.sharded_gzip_compress_multihost(data, level,
member_size=...)`` in every process at once (each compresses its block of
members on its card, then the pieces, sizes and index metadata are
all-gathered), judged as the single-process archive is
(``entries/archive.py``).  The rooflines count this process's members."""

from __future__ import annotations

from benchmark.entries import archive


class Entry(archive.Entry):

    def __init__(self, config: dict, traffic: dict, device: str):
        super().__init__(config, traffic, device)
        if self.kind != "compress":
            raise ValueError("the multi-process archive is written, not read")
        from decompress_tpu_torch.parallel import multihost

        self._multihost = multihost  # looked up at each call, so a test can break it underneath

    def call(self, payload) -> bytes:
        return self._multihost.sharded_gzip_compress_multihost(
            payload, self.level, member_size=self.member_size, device=self.device)

    def batches(self, n: int) -> list:
        """This process's block of members (the writer's block layout), in
        chunks of ``BATCH`` rows."""
        import torch.distributed as dist

        world, rank = dist.get_world_size(), dist.get_rank()
        total = -(-n // self.member_size)
        per = -(-total // world)
        m = max(0, min(total, (rank + 1) * per) - min(total, rank * per))
        return [(min(archive.BATCH, m - lo), self.member_size, self.member_size)
                for lo in range(0, m, archive.BATCH)]


def make(config: dict, traffic: dict, device: str) -> Entry:
    return Entry(config, traffic, device)
