"""Per-file gzip: a call is a pass over the corpus's files as they lie in
one input, each file its own ``decompress_tpu_torch.gz.compress(file,
level)``, the members joined in the input's order (``gzip -c -6
FILE...``).  Each member is judged by ``reference.check_gzip`` against
its file.

Every input of the mix is one whole copy of the corpus, its files in a
drawn order (``benchmark/inputs.py``), so set-up finds the files in each
input once, and every input gives the same batches.
"""

from __future__ import annotations

import numpy as np

from benchmark import inputs, reference
from benchmark.entries import gzip_oneshot

KERNELS = gzip_oneshot.KERNELS


def split(data: np.ndarray, files: list[np.ndarray]) -> list[np.ndarray]:
    """The slices of ``data`` that hold ``files``, whole, one after
    another in some order; raises ValueError where ``data`` is not so
    made."""
    total = sum(f.size for f in files)
    if data.size != total:
        raise ValueError(f"{data.size} bytes are not one copy of a {total}-byte corpus")
    left = list(range(len(files)))
    out, pos = [], 0
    while pos < data.size:
        j = next((j for j in left if np.array_equal(data[pos:pos + files[j].size], files[j])),
                 None)
        if j is None:
            raise ValueError(f"no whole file of the corpus at byte {pos}")
        left.remove(j)
        out.append(data[pos:pos + files[j].size])
        pos += files[j].size
    return out


class Files:
    """A call's payload: the files' slices of one input, in order;
    ``len()`` is the input's bytes, what the rate counts."""

    def __init__(self, parts: list[np.ndarray]):
        self.parts = parts
        self.nbytes = sum(p.size for p in parts)

    def __len__(self) -> int:
        return self.nbytes


class Entry(gzip_oneshot.Entry):
    def __init__(self, config: dict, traffic: dict, device: str):
        super().__init__(config, traffic, device)
        self.files = inputs.load_corpus(config["corpus"])

    def prepare(self, data) -> Files:
        return Files(split(data, self.files))

    def call(self, payload: Files) -> bytes:
        return b"".join(self._gz.compress(p, self.level, device=self.device)
                        for p in payload.parts)

    def judge(self, data, out: bytes, rng) -> dict:
        """Faults of the members in ``out`` against the files of ``data``:
        each member's by ``reference.check_gzip``, summed; ``members`` 1
        where the members are not one per file, nothing after the last; a
        member that does not parse counts under ``bytes``, and the
        split stops there."""
        faults = {"members": 0, "header": 0, "bytes": 0, "trailer": 0}
        parts = split(data, self.files)
        pos = found = 0
        for part in parts:
            if pos >= len(out):
                break
            try:
                _, body = reference.parse_header(out, pos)
                _, end = reference.inflate_member(out, body)
            except reference.Malformed:
                faults["bytes"] += 1
                break
            for k, v in reference.check_gzip(out[pos:end + 8], part, self.header).items():
                faults[k] += v
            pos, found = end + 8, found + 1
        faults["members"] = int(found != len(parts) or pos != len(out))
        return faults

    def batches(self, n: int) -> list:
        """(rows, row bytes, segment bytes) of each file's batches, over
        the files of an input of n bytes, one copy of the corpus."""
        if n != sum(f.size for f in self.files):
            raise ValueError(f"{n} bytes are not one copy of the corpus")
        return [b for f in self.files for b in super().batches(f.size)]


def make(config: dict, traffic: dict, device: str) -> Entry:
    return Entry(config, traffic, device)
