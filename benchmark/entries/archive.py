"""The indexed member-parallel archive: a ``compress`` call is
``sharded_gzip_compress(data, level, member_size=...)`` with the index
on, judged by ``reference.check_archive``; a ``decompress`` call is
``sharded_gzip_decompress(archive)`` (``expand="auto"``) of an archive
the port wrote from the input during set-up, judged by its bytes.

Members are ``member_size`` bytes with no history, analysed in chunks of
``BATCH`` rows (the program's shapes, for the rooflines).
"""

from __future__ import annotations

from benchmark import reference

BATCH = 8
KERNELS = ("fields", "probe", "extend", "mark_path", "histograms", "litbits_pref",
           "gain", "build_slots", "crc_rows")


class Entry:
    kernels = KERNELS

    def __init__(self, config: dict, traffic: dict, device: str):
        from decompress_tpu_torch.parallel import sharded

        self._sharded = sharded  # looked up at each call, so a test can break it underneath
        self.kind = traffic["call"]
        if self.kind not in ("compress", "decompress"):
            raise ValueError(f"an archive call is compress or decompress, not {self.kind!r}")
        self.level = config["level"]
        self.member_size = config["member_size"]
        self.header = config["header"]
        self.index = config["index"]
        self.walk = traffic.get("walk_members", 0)
        self.device = device

    def _write(self, data) -> bytes:
        return self._sharded.sharded_gzip_compress(
            data, self.level, member_size=self.member_size, device=self.device)

    def prepare(self, data):
        """What a call takes: the input, or for a decode the archive the
        port writes from it."""
        return self._write(data) if self.kind == "decompress" else data

    def call(self, payload) -> bytes:
        if self.kind == "decompress":
            return self._sharded.sharded_gzip_decompress(payload, device=self.device)
        return self._write(payload)

    def judge(self, data, out: bytes, rng) -> dict:
        if self.kind == "decompress":
            return {"bytes": int(out != memoryview(data).cast("B"))}
        members = -(-len(data) // self.member_size)
        walk = set(rng.choice(members, size=min(self.walk, members), replace=False).tolist())
        return reference.check_archive(out, data, self.member_size, self.header,
                                       self.index, walk)

    def counters(self) -> dict:
        """The program's decode counters: serial-route uses and card
        retries, summed over their reasons."""
        return {"serial_fallbacks": sum(self._sharded.serial_fallbacks.values()),
                "card_retries": sum(self._sharded.card_retries.values())}

    def window_checks(self, delta: dict) -> dict:
        """A decode's guarantee that every archive decodes on the card:
        serial-route uses in the window, each a fault."""
        if self.kind != "decompress":
            return {}
        return {"serial_fallbacks": delta["serial_fallbacks"]}

    def batches(self, n: int) -> list:
        """(rows, row bytes, segment bytes) of each chunk a compress call
        on n input bytes analyses; a decode runs none of these kernels."""
        if self.kind == "decompress":
            return []
        m = -(-n // self.member_size)
        return [(min(BATCH, m - lo), self.member_size, self.member_size)
                for lo in range(0, m, BATCH)]


def make(config: dict, traffic: dict, device: str) -> Entry:
    return Entry(config, traffic, device)
