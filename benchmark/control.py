"""The control of the check that decides ``correct``: the plain reference
put in the program's place, with one guarantee that the configuration
states broken, as a later change might be tempted to break it.  Its
outputs must come out as not correct.

* ``gzip_oneshot``: a gzip stream from Python's ``zlib`` at the same
  level, with the trailer's CRC-32 left at zero (a checksum skipped).
* ``archive``, compress: members from ``zlib`` with a full index (TZ
  sizes, TB splits from each member's commands), except that every TB
  split sits at its multiple of the stride and not at the command that
  holds it (splits not looked up).
* ``archive``, decompress: each member decoded by ``zlib`` into a row of
  ``member_size`` bytes and the rows returned whole, the last one's
  padding with them (a fixed-shape output not cut to its length).

Run on the cell's own inputs::

    python3 -m benchmark.control --workload <name> --seeds 1 2 3

prints, for each seed, the check's numbers for the control's outputs;
:func:`control_entry` puts the control in the program's place for a run
of the harness (``benchmark/tests``).
"""

from __future__ import annotations

import argparse
import sys
import zlib

import numpy as np

from benchmark import inputs, reference, spec


def gzip_member(data, level: int, header: dict, *, crc=None, extra: bytes | None = None,
                body: bytes | None = None) -> bytes:
    """One gzip member of ``data`` with the stated header fields, its
    DEFLATE body from zlib (or ``body``), and its trailer."""
    raw = memoryview(np.ascontiguousarray(data)).cast("B")
    if body is None:
        c = zlib.compressobj(level, zlib.DEFLATED, -15)
        body = c.compress(raw) + c.flush()
    flags = header["flags"] | (reference.FEXTRA if extra is not None else 0)
    head = (b"\x1f\x8b\x08" + bytes([flags]) + header["mtime"].to_bytes(4, "little")
            + bytes([header["xfl"], header["os"]]))
    if extra is not None:
        head += len(extra).to_bytes(2, "little") + extra
    crc = zlib.crc32(raw) if crc is None else crc
    return head + body + crc.to_bytes(4, "little") + (len(raw) & 0xFFFFFFFF).to_bytes(4, "little")


def archive(data, level: int, member_size: int, header: dict, index: dict, *,
            splits_at_stride: bool = False, splits: bool = True) -> bytes:
    """An indexed archive of ``data`` from zlib members, its TB splits
    taken from each member's commands (``reference.walk_deflate``), or
    with ``splits_at_stride`` put at the stride's multiples, or without
    ``splits`` left empty (what a decode's judge does not read)."""
    raw = np.ascontiguousarray(data)
    bodies, rows = [], []
    for lo in range(0, max(1, raw.size), member_size):
        c = zlib.compressobj(level, zlib.DEFLATED, -15)
        body = c.compress(raw[lo:lo + member_size].tobytes()) + c.flush()
        commands = reference.walk_deflate(body)[0] if splits else None
        if commands is None:
            rows.append((0, []))
        else:
            maxc, deltas = reference.expected_tb_row(commands, index["split_bits"],
                                                     index["n_splits"], index["row_cap"])
            rows.append((maxc, [0] * len(deltas) if splits_at_stride else deltas))
        bodies.append(body)
    m = len(bodies)
    tb = index["split_bits"].to_bytes(4, "little") + b"".join(
        len(d).to_bytes(2, "little") + maxc.to_bytes(2, "little") + bytes(d)
        for maxc, d in rows)
    tz_len = 4 + 4 * m
    xlen = 4 + tz_len + 4 + len(tb)
    sizes = [10 + len(b) + 8 for b in bodies]
    sizes[0] += 2 + xlen
    extra = (reference.TZ + tz_len.to_bytes(2, "little") + m.to_bytes(4, "little")
             + b"".join(s.to_bytes(4, "little") for s in sizes)
             + reference.TB + len(tb).to_bytes(2, "little") + tb)
    return b"".join(
        gzip_member(raw[k * member_size:(k + 1) * member_size], level, header,
                    extra=extra if k == 0 else None, body=b)
        for k, b in enumerate(bodies))


def padded_decode(archive_bytes: bytes, member_size: int) -> bytes:
    """Every member decoded by zlib into a row of ``member_size`` bytes,
    the rows returned whole."""
    out, pos = [], 0
    while pos < len(archive_bytes):
        _, body = reference.parse_header(archive_bytes, pos)
        decoded, end = reference.inflate_member(archive_bytes, body)
        out.append(decoded.ljust(member_size, b"\x00"))
        pos = end + 8
    return b"".join(out)


class ControlEntry:
    """A configuration's entry with the control in the program's place."""

    def __init__(self, entry, config: dict):
        self.entry = entry
        self.config = config
        self.kind = entry.kind
        self.kernels = entry.kernels

    def prepare(self, data):
        if self.kind == "decompress":
            c = self.config
            return archive(data, c["level"], c["member_size"], c["header"], c["index"],
                           splits=False)
        return data

    def call(self, payload) -> bytes:
        c = self.config
        if c["entry"] == "gzip_oneshot":
            return gzip_member(payload, c["level"], c["header"], crc=0)
        if self.kind == "decompress":
            return padded_decode(payload, c["member_size"])
        return archive(payload, c["level"], c["member_size"], c["header"], c["index"],
                       splits_at_stride=True)

    def judge(self, data, out, rng):
        return self.entry.judge(data, out, rng)

    def counters(self) -> dict:
        return self.entry.counters()

    def window_checks(self, delta: dict) -> dict:
        return self.entry.window_checks(delta)

    def batches(self, n: int) -> list:
        return self.entry.batches(n)


def control_entry(config: dict, traffic: dict, device: str) -> ControlEntry:
    entry = spec.load_module("entries", config["entry"]).make(config, traffic, device)
    return ControlEntry(entry, config)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the control's check numbers on a cell's inputs")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    config, traffic = cell["config"], cell["traffic"]
    ctl = control_entry(config, traffic, "cpu")
    for seed in args.seeds:
        rng = np.random.default_rng((seed % (1 << 64), 1 << 20))
        data = inputs.make_inputs(config["corpus"], traffic["input_bytes"], seed,
                                  traffic["inputs"])
        faults: dict = {}
        for x in data:
            out = ctl.call(ctl.prepare(x))
            for k, v in ctl.judge(x, out, rng).items():
                faults[k] = faults.get(k, 0) + v
        print(f"control {args.workload} seed {seed}: "
              + " ".join(f"wrong_{k} {v} limit 0" for k, v in faults.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
