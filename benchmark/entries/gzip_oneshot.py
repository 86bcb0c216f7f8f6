"""One-shot gzip: a call is ``decompress_tpu_torch.gz.compress(data,
level)`` of one input; the output is judged by ``reference.check_gzip``.

The stream's DEFLATE segments are ``SEGMENT`` bytes behind up to
``HISTORY`` bytes of window, analysed in batches of ``BATCH`` rows of
``HISTORY + SEGMENT`` bytes (the program's shapes, for the rooflines).
"""

from __future__ import annotations

from benchmark import reference

SEGMENT = 130_560
HISTORY = 32_768
BATCH = 8
#: the kernels a call runs, by their roofline files' names
KERNELS = ("fields", "probe", "extend", "mark_path", "histograms", "litbits_pref",
           "gain", "build_slots")


class Entry:
    kind = "compress"
    kernels = KERNELS

    def __init__(self, config: dict, traffic: dict, device: str):
        from decompress_tpu_torch import gz

        self._gz = gz  # looked up at each call, so a test can break it underneath
        self.level = config["level"]
        self.header = config["header"]
        self.device = device

    def prepare(self, data):
        """What a call takes: the input itself."""
        return data

    def call(self, payload) -> bytes:
        return self._gz.compress(payload, self.level, device=self.device)

    def judge(self, data, out: bytes, rng) -> dict:
        return reference.check_gzip(out, data, self.header)

    def counters(self) -> dict:
        return {}

    def window_checks(self, delta: dict) -> dict:
        return {}

    def batches(self, n: int) -> list:
        """(rows, row bytes, segment bytes) of each batch of a call on n
        input bytes."""
        segs = -(-n // SEGMENT)
        return [(min(BATCH, segs - lo), HISTORY + SEGMENT, SEGMENT)
                for lo in range(0, segs, BATCH)]


def make(config: dict, traffic: dict, device: str) -> Entry:
    return Entry(config, traffic, device)
