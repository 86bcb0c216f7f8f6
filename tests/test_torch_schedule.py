"""Dispatch-ahead scheduling: the port's ``de._deflate_pipelined`` and the
sharded writer's windowed chunks against the reference's, on the CPU.

* (a) ``de.deflate`` / ``gz.compress`` at levels 1 and 6 write the
  reference's bytes on 17 to 56 segments (more than PIPELINE_DEPTH x
  MAX_DEVICE_BATCH in three cases), with batches built both ways (segments
  shorter than the 32 KiB history carry their own, longer ones take it
  from the previous row), and with a preset dictionary;
* (b) in the same runs the round-A dispatches (S) and finishes (F) come
  in the reference's order, S0 S1 S2 S3 S4 F0 S5 F1 ...: the port's
  ``analyze2_start`` / ``analyze2_finish`` against the reference's
  top-level ``lz77_analyze`` / ``analyze2_finish`` (calls nested inside
  a finish do not count), each batch named by its data;
* (c) ``_compress_members`` dispatches round A of chunk i (A), drains
  chunk i-1's packs (D, ``de.drain``), finishes chunk i (F) and
  dispatches its packs (P) in the reference's ``_windowed`` order, on one
  device and on a mesh of two, with the reference's archive bytes;
* (d) ``PIPELINE_DEPTH`` equals the reference's (also held in
  ``tests/test_torch_core.py``), and depth 1 writes the same bytes;
* ``ops/transfer.read`` uses a result's queued copy only for the tensors
  that copy holds;
* ``de.batch_rows`` stages the same rows on every layout it picks.

Nothing in the reference is edited: its functions are wrapped by
``monkeypatch`` for the length of a run.
"""

import gzip
import hashlib
import pathlib
import zlib

import numpy as np
import pytest
import torch

from decompress_tpu import de as ref_de
from decompress_tpu import gz as ref_gz
from decompress_tpu import native as ref_native
from decompress_tpu import parallel as ref_parallel
from decompress_tpu.ops import checksum as ref_checksum
from decompress_tpu.ops import lz77 as ref_lz77
from decompress_tpu.parallel import sharded as ref_sharded
from decompress_tpu_torch import de, gz, parallel
from decompress_tpu_torch.ops import lz77, transfer
from decompress_tpu_torch.parallel import sharded
from torch_threads import one_torch_thread  # noqa: F401

CORPUS = b"".join(p.read_bytes() for p in sorted(
    (pathlib.Path(__file__).parent / "corpus").iterdir()))
DICTIONARY = CORPUS[-40000:]

#: (segments, segment size, level, preset dictionary, entry point)
CASES = {
    "own-history-l1": (56, 4096, 1, False, "deflate"),
    "own-history-l6-gz": (40, 4096, 6, False, "gz"),
    "previous-row-l1": (33, 32768, 1, False, "deflate"),
    "previous-row-l6-dictionary": (17, 32768, 6, True, "deflate"),
}


def _key(data) -> str:
    return hashlib.sha1(np.asarray(data).tobytes()).hexdigest()


class _Order:
    """Calls of wrapped functions as (letter, key) events; calls made
    while a finish runs are nested and not recorded."""

    def __init__(self):
        self.events = []
        self.depth = 0

    def dispatch(self, fn, letter, data_at=0, key=True):
        def wrapped(*args, **kw):
            if self.depth == 0:
                self.events.append((letter, _key(args[data_at]) if key else None))
            return fn(*args, **kw)
        return wrapped

    def finish(self, fn, letter, data_at=1):
        def wrapped(*args, **kw):
            if self.depth == 0:
                self.events.append((letter, _key(args[data_at])))
            self.depth += 1
            try:
                return fn(*args, **kw)
            finally:
                self.depth -= 1
        return wrapped

    def named(self):
        """The events with each batch numbered by its first dispatch."""
        index = {}
        for letter, key in self.events:
            if letter == "S":
                index.setdefault(key, len(index))
        return [f"{letter}{index[key]}" for letter, key in self.events]


def _expected(batches: int, depth: int) -> list:
    seq = [f"S{i}" for i in range(min(depth, batches))]
    ahead = len(seq)
    for i in range(batches):
        if ahead < batches:
            seq.append(f"S{ahead}")
            ahead += 1
        seq.append(f"F{i}")
    return seq


def _compress(pkg_de, pkg_gz, data, seg, level, dictionary, via, **kw):
    if via == "gz":
        return pkg_gz.compress(data, level, segment_size=seg, **kw)
    return pkg_de.deflate(data, level, segment_size=seg,
                          dictionary=DICTIONARY if dictionary else None, **kw)


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    """Both packages' output and S/F order for one case, run once."""
    nseg, seg, level, dictionary, via = CASES[request.param]
    data = CORPUS[: nseg * seg - 100]  # a short final segment
    with pytest.MonkeyPatch.context() as mp:
        ref_order = _Order()
        mp.setattr(ref_lz77, "analyze2_finish",
                   ref_order.finish(ref_lz77.analyze2_finish, "F"))
        mp.setattr(ref_lz77, "lz77_analyze",
                   ref_order.dispatch(ref_lz77.lz77_analyze, "S"))
        want = _compress(ref_de, ref_gz, data, seg, level, dictionary, via)
        order = _Order()
        mp.setattr(lz77, "analyze2_finish", order.finish(lz77.analyze2_finish, "F"))
        mp.setattr(lz77, "analyze2_start", order.dispatch(lz77.analyze2_start, "S"))
        got = _compress(de, gz, data, seg, level, dictionary, via, device="cpu")
    batches = -(-nseg // de.MAX_DEVICE_BATCH)
    return dict(data=data, via=via, want=want, got=got, batches=batches,
                ref_order=ref_order.named(), order=order.named())


def test_pipelined_bytes_match_reference(runs):
    assert runs["got"] == runs["want"]
    if runs["via"] == "gz":
        assert gzip.decompress(runs["got"]) == runs["data"]
    else:
        z = zlib.decompressobj(-15, zdict=DICTIONARY)
        assert z.decompress(runs["got"]) + z.flush() == runs["data"]


def test_pipelined_order_matches_reference(runs):
    want = _expected(runs["batches"], ref_de.PIPELINE_DEPTH)
    assert runs["ref_order"] == want
    assert runs["order"] == want


def test_expected_order_interleaves():
    """The order the tests above hold both packages to, spelled out."""
    assert _expected(7, 4) == ["S0", "S1", "S2", "S3", "S4", "F0", "S5", "F1", "S6",
                               "F2", "F3", "F4", "F5", "F6"]
    assert _expected(3, 4) == ["S0", "S1", "S2", "F0", "F1", "F2"]
    assert _expected(3, 1) == ["S0", "S1", "F0", "S2", "F1", "F2"]


def test_read_takes_the_queued_copy_of_its_own_tensors_only():
    """transfer.read answers from a result's queued Fetch where it holds
    the very tensors asked for, and from a fresh Fetch where an entry was
    replaced after the copy was queued."""
    res = transfer.Queued({"exact": torch.tensor([True, False]),
                           "hist_lit": torch.arange(4)}, ["exact", "hist_lit"])
    queued = res.fetch
    (exact,) = transfer.read(res, "exact")
    assert exact.tolist() == [True, False] and res.fetch is queued
    assert queued.holds({"exact": res["exact"]})
    res["hist_lit"] = torch.arange(4) + 10
    assert not queued.holds({"hist_lit": res["hist_lit"]})
    (hist_lit,) = transfer.read(res, "hist_lit")
    assert hist_lit.tolist() == [10, 11, 12, 13]
    (plain,) = transfer.read({"exact": torch.tensor([True])}, "exact")
    assert plain.tolist() == [True]


#: (chunk starts, history starts or None for the chunk's own HIST bytes
#: before it, segment size) of batch_rows' layouts
ROW_CASES = {
    "previous-row": ([40000 + 32768 * i for i in range(5)], None, 32768),
    "previous-row-short-tail": ([40000, 72768, 105536], None, 32768),
    "unrelated-history": ([40000, 72768, 200000], [0, 7232, 90000], 32768),
    "own-history": ([40000 + 4096 * i for i in range(3)], None, 4096),
}


@pytest.mark.parametrize("case", sorted(ROW_CASES))
def test_batch_rows_layouts_stage_the_same_rows(case):
    """Whatever layout de.batch_rows picks (payload rows whose histories
    the card takes from the row before, or rows carrying their own), the
    staged rows are each chunk behind its own history."""
    starts, hist_starts, seg = ROW_CASES[case]
    raw = np.frombuffer(CORPUS, np.uint8)
    stops = [s + seg for s in starts]
    if case.endswith("short-tail"):
        stops[-1] -= 1000
    chunks = [raw[a:b] for a, b in zip(starts, stops)]
    hists = [raw[max(0, s - lz77.HIST):s] if hist_starts is None else
             raw[h:h + lz77.HIST] for s, h in zip(starts, hist_starts or starts)]
    rows = de.batch_rows(chunks, hists, seg)
    assert (rows.head is not None) == case.startswith("previous-row")
    batch = de.Batch(rows, torch.device("cpu"))
    want = np.zeros((len(rows.n_valid), lz77.HIST + seg), np.uint8)
    for i, (c, h) in enumerate(zip(chunks, hists)):
        want[i, lz77.HIST - h.size:lz77.HIST] = h
        want[i, lz77.HIST:lz77.HIST + c.size] = c
    b = len(chunks)
    np.testing.assert_array_equal(batch.data[:b].numpy(), want[:b])
    assert batch.n_valid[:b].tolist() == [c.size for c in chunks]
    assert batch.hist_len[:b].tolist() == [h.size for h in hists]


def test_pipeline_depth_matches_reference():
    assert de.PIPELINE_DEPTH == ref_de.PIPELINE_DEPTH == 4


def test_pipeline_depth_one_writes_the_same_bytes(monkeypatch):
    """The schedule changes no byte: depth 1 equals depth 4."""
    data = CORPUS[: 20 * 4096]
    want = de.deflate(data, 1, segment_size=4096, device="cpu")
    monkeypatch.setattr(de, "PIPELINE_DEPTH", 1)
    order = _Order()
    monkeypatch.setattr(lz77, "analyze2_finish", order.finish(lz77.analyze2_finish, "F"))
    monkeypatch.setattr(lz77, "analyze2_start", order.dispatch(lz77.analyze2_start, "S"))
    assert de.deflate(data, 1, segment_size=4096, device="cpu") == want
    assert order.named() == _expected(3, 1)


# ---------------------------------------------------------------------------
# (c) the sharded writer's windowed chunks
# ---------------------------------------------------------------------------

MEMBER = 4096
MEMBERS = 40


def _collapse(letters: list) -> str:
    """A, F, P and D letters with runs of one letter merged (a chunk's
    device groups each record their own A, F and P)."""
    out = []
    for c in letters:
        if not out or out[-1] != c:
            out.append(c)
    return "".join(out)


def _windowed(chunks: int) -> str:
    return "AFP" + "ADFP" * (chunks - 1) + "D"


@pytest.mark.parametrize("n_devices", [1, 2])
def test_windowed_chunks_match_reference(n_devices, monkeypatch):
    data = CORPUS[: MEMBERS * MEMBER - 300]
    ref_order = _Order()
    monkeypatch.setattr(ref_lz77, "analyze2_start",
                        ref_order.dispatch(ref_lz77.analyze2_start, "A", key=False))
    monkeypatch.setattr(ref_lz77, "analyze2_finish",
                        ref_order.finish(ref_lz77.analyze2_finish, "F"))
    monkeypatch.setattr(ref_de, "_pack_segments",
                        ref_order.dispatch(ref_de._pack_segments, "P", key=False))
    # without the reference's host library its drain computes the member
    # CRC-32s with crc32_batch_device: that call marks a drain
    monkeypatch.setattr(ref_native, "available", lambda: False)
    monkeypatch.setattr(ref_checksum, "crc32_batch_device",
                        ref_order.dispatch(ref_checksum.crc32_batch_device, "D", key=False))
    want = ref_sharded.sharded_gzip_compress(
        data, 6, member_size=MEMBER,
        mesh=ref_parallel.make_mesh(n_devices) if n_devices > 1 else None)

    order = _Order()
    monkeypatch.setattr(lz77, "analyze2_start", order.dispatch(lz77.analyze2_start, "A",
                                                               key=False))
    monkeypatch.setattr(lz77, "analyze2_finish", order.finish(lz77.analyze2_finish, "F"))
    monkeypatch.setattr(de, "pack_segments", order.dispatch(de.pack_segments, "P", key=False))
    monkeypatch.setattr(de, "drain", order.dispatch(de.drain, "D", key=False))
    got = sharded.sharded_gzip_compress(
        data, 6, member_size=MEMBER, mesh=parallel.make_mesh(n_devices, device="cpu"))

    assert got == want
    assert gzip.decompress(got) == data
    chunks = -(-MEMBERS // (de.MAX_DEVICE_BATCH * n_devices))
    letters = [e[0] for e in ref_order.events]
    assert _collapse(letters) == _windowed(chunks)
    assert _collapse([e[0] for e in order.events]) == _windowed(chunks)
    # one A, F and P per device group: each chunk's groups all go out
    # before its drain
    groups = sum(len(sharded._shard_rows(lo, MEMBERS, n_devices))
                 for lo in range(0, MEMBERS, de.MAX_DEVICE_BATCH * n_devices))
    assert [e[0] for e in order.events].count("A") == groups
    assert [e[0] for e in order.events].count("D") == chunks


def test_windowed_zlib_matches_reference():
    """sharded_zlib_compress (no member CRC) takes the same schedule."""
    data = CORPUS[: 20 * MEMBER]
    want = ref_sharded.sharded_zlib_compress(data, 6, member_size=MEMBER)
    got = sharded.sharded_zlib_compress(data, 6, member_size=MEMBER, device="cpu")
    assert got == want and zlib.decompress(got) == data


def test_shared_tree_drains_after_every_analysis(monkeypatch):
    """With shared_tree every chunk is analysed before the first pack."""
    data = CORPUS[: 20 * MEMBER]
    order = _Order()
    monkeypatch.setattr(lz77, "analyze2_start", order.dispatch(lz77.analyze2_start, "A",
                                                               key=False))
    monkeypatch.setattr(lz77, "analyze2_finish", order.finish(lz77.analyze2_finish, "F"))
    monkeypatch.setattr(de, "pack_segments", order.dispatch(de.pack_segments, "P", key=False))
    monkeypatch.setattr(de, "drain", order.dispatch(de.drain, "D", key=False))
    got = sharded.sharded_gzip_compress(data, 6, member_size=MEMBER, shared_tree=True,
                                        device="cpu")
    assert got == ref_sharded.sharded_gzip_compress(data, 6, member_size=MEMBER,
                                                    shared_tree=True)
    assert "".join(e[0] for e in order.events) == "AFAFAF" + "PD" * 3
