"""Meshes, the fixed-Huffman step over a mesh, the multi-process archive
and ``CodecConfig``: the port (``decompress_tpu_torch``, plain PyTorch
versions of the kernels, ``device="cpu"`` meshes) against the reference
(``decompress_tpu``, JAX on the CPU with its 8 virtual devices).

* archives at mesh sizes 1, 2 and 8 equal each other and the reference's,
  with and without ``shared_tree``, on members whose device groups
  differ: a noise pair with no hot strides (the hot lane is skipped where
  the reference's batch of 8 runs it), a member with hot strides, and the
  trim-repair segment of ``tests/test_trim_repair.py`` with one round-A
  candidate overestimated in both packages (its group takes the trim
  loop alone, the reference's whole batch does); ``sharded_zlib_compress``
  likewise; the card decode on the CPU restores them;
* ``compress_step_sharded`` on ``make_mesh(8, "cpu")`` equals the
  reference's on ``make_mesh(8)``: words, ``sizes_all`` and
  ``total_bits``, shapes and dtypes;
* the multi-process index assembly from ``return_meta`` rebuilds the
  single-process archive;
* the index encoder ``_build_index`` (int64 arrays, lists of tuples)
  writes the reference's bytes on drawn split tables: TB, deltas out of
  range and ``SPLIT_BITS`` 0 (TS), rows with no valid triple or with
  zeros between them, command steps and counts at and over the TB cap,
  TS at and over its 64 KiB limit (sizes only), too many members (none);
  ``_assemble_index`` over a four-process gather of 515 members (the
  last process short, junk in its padding row) joins that index, and
  ``sharded.INDEX_COUNTS`` counts each index by subfield;
* ``CodecConfig``: fields, defaults and ``validate()`` messages as the
  reference's (``platform`` is ``device``), and the ``config=`` wiring of
  ``de.deflate`` and ``sharded_gzip_compress`` writes the reference's
  bytes;
* two gloo processes (a ``file://`` rendezvous) writing
  ``sharded_gzip_compress_multihost``: both archives equal the
  single-process archive and the reference's, and each process's trace
  holds its ``processes.wait`` and ``processes.gather`` spans inside its
  call; ``initialize`` stays single-process without an address and
  raises on a bad one;
* four gloo processes, one of them owning no member or the last a short
  block: every archive equals the single-process archive and the
  reference's and decodes to the input; each call records one
  ``processes.wait``, two ``processes.gather`` and one
  ``processes.index``, none inside another, and ``multihost.COUNTS``
  moves by three collectives and the bytes of the padded pieces and the
  metadata rows;
* ``utils.profiling``: a trace of the sharded writer holds its stages'
  spans.
"""

import dataclasses
import gzip
import json
import os
import pathlib
import subprocess
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decompress_tpu import de as ref_de
from decompress_tpu import parallel as ref_parallel
from decompress_tpu.ops import lz77 as ref_lz77
from decompress_tpu.parallel import sharded as ref
from decompress_tpu.utils import config as ref_config
from decompress_tpu_torch import de, gz, parallel
from decompress_tpu_torch.ops import lz77
from decompress_tpu_torch.parallel import multihost, sharded
from decompress_tpu_torch.utils import config, profiling
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
MEMBER = 4096


def _trim_segment() -> bytes:
    """The trim-repair segment of tests/test_trim_repair.py."""
    rng = np.random.default_rng(7)
    base = bytes(rng.integers(32, 96, 700, dtype=np.uint8))
    return ((base + b"abcdefgh" * 40 + base[:500] + b"abcdefgi" * 40 + base) * 3)[:MEMBER]


TRIM = _trim_segment()


def _payload() -> bytes:
    """12 members: 6 of text, 2 of noise, text, the trim segment, 24-byte
    records (hot strides) and a 1,500-byte tail.  At mesh size 8 the
    device groups are the member pairs, at mesh size 1 the reference's
    batches of 8 and 4."""
    rng = np.random.default_rng(42)
    text = (b"sharded gzip member payload -- " * 2000)[:7 * MEMBER]
    noise = rng.integers(0, 256, 2 * MEMBER, dtype=np.uint8).tobytes()
    records = b"".join(b"id=%06d;val=abcdefghij\n" % (i * 7919 % 999983)
                       for i in range(200))[:MEMBER]
    return (text[:6 * MEMBER] + noise + text[6 * MEMBER:] + TRIM + records
            + text[:1500])


PAYLOAD = _payload()


def _overestimate_trim_rows(start, reparse, to_np, from_np):
    """``start`` (an ``analyze2_start``) whose rows holding the trim
    segment come back inexact: their first selected match of 16..199 bytes
    that ends before a mismatch has its candidate 5 bytes too long, and
    the rows are re-parsed from those candidates (the two-round level 6)."""
    def wrapped(data, n_valid, hist_len, **kw):
        res = start(data, n_valid, hist_len, **kw)
        rows = to_np(data)
        mask = np.array([r[:MEMBER].tobytes() == TRIM for r in rows])
        if not mask.any():
            return res
        arrs = {k: to_np(v) for k, v in res.items()}
        cl = arrs["cand_length"].copy()
        for i in np.nonzero(mask)[0]:
            ln, dist = arrs["length"][i], arrs["dist"][i]
            s = next(int(s) for s in np.nonzero(arrs["is_match"][i])[0]
                     if 16 <= ln[s] < 200 and s + ln[s] + 8 < MEMBER
                     and rows[i, s + ln[s]] != rows[i, s + ln[s] - dist[s]])
            cl[i, s] += 5
        bad = reparse(data, from_np(cl), res["cand_dist"], n_valid, seg_len=kw["seg_len"],
                      hist=kw["hist"], lazy=True, two_round=True)
        out = {}
        for k, v in arrs.items():
            m = mask.reshape(-1, *[1] * (v.ndim - 1))
            out[k] = from_np(np.where(m, to_np(bad[k]), v))
        return out
    return wrapped


@pytest.fixture
def trim_loop(monkeypatch):
    """Both packages' round A overestimates in the trim segment's row."""
    monkeypatch.setattr(ref_lz77, "analyze2_start", _overestimate_trim_rows(
        ref_lz77.analyze2_start, ref_lz77.lz77_reparse_greedy, np.asarray, jnp.asarray))
    monkeypatch.setattr(lz77, "analyze2_start", _overestimate_trim_rows(
        lz77.analyze2_start, lz77.lz77_reparse_greedy, lambda t: t.cpu().numpy(),
        torch.from_numpy))
    finish = lz77.analyze2_finish
    inexact = []

    def counted(res, *args, **kw):
        inexact.append(not bool(res["exact"].all()))
        return finish(res, *args, **kw)

    monkeypatch.setattr(lz77, "analyze2_finish", counted)
    return inexact


def test_payload_groups_differ():
    """The noise pair has no hot strides, the records row has, and no
    device group at mesh size 8 holds both the trim segment and it."""
    arr = np.frombuffer(PAYLOAD, np.uint8)
    rows = de.batch_rows([arr[i * MEMBER:(i + 1) * MEMBER] for i in range(12)], None, MEMBER,
                         rows=12)
    data, nv = rows.data, rows.n_valid
    assert len(nv) == 12 and data[9].tobytes() == TRIM
    res = lz77.analyze2_start(torch.from_numpy(data), torch.from_numpy(nv),
                              torch.zeros(12, dtype=torch.int32), level=6,
                              seg_len=MEMBER, hist=0)
    hot = lz77._hot_dists_host(res["dist_counts"].numpy())
    assert not hot[6:8].any() and hot[10].any()
    assert [g[1:3] for g in sharded._shard_rows(0, 12, 8)] == [(2 * k, 2) for k in range(6)]
    assert [g[1:] for g in sharded._shard_rows(0, 12, 1)] == [(0, 8, 8)]
    assert [g[1:] for g in sharded._shard_rows(8, 12, 1)] == [(8, 4, 4)]
    assert [g[1:] for g in sharded._shard_rows(0, 12, 2)] == [(0, 8, 8), (8, 4, 8)]


def test_shard_rows_pads_as_the_reference():
    """Tail chunks pad to max(d, 2^ceil(log2 b)) rows, then to a multiple
    of d; every member lands in exactly one group, in order."""
    for d in (1, 2, 3, 8):
        for m in (1, 5, 8, 17, 40):
            seen = []
            for lo in range(0, m, 8 * d):
                b = min(8 * d, m - lo)
                b_pad = 8 * d if b == 8 * d else max(d, 1 << (b - 1).bit_length())
                b_pad += -b_pad % d
                groups = sharded._shard_rows(lo, m, d)
                assert all(rows == b_pad // d for *_, rows in groups)
                seen += [i for _, glo, b_k, _ in groups for i in range(glo, glo + b_k)]
            assert seen == list(range(m)), (d, m)


@pytest.mark.parametrize("shared_tree", [False, True])
@pytest.mark.parametrize("repair", [False, True], ids=["plain", "trim_loop"])
def test_mesh_archives_match_reference(request, shared_tree, repair):
    inexact = request.getfixturevalue("trim_loop") if repair else None
    want = ref.sharded_gzip_compress(PAYLOAD, 6, member_size=MEMBER, shared_tree=shared_tree)
    for n in (1, 2, 8):
        got = sharded.sharded_gzip_compress(PAYLOAD, 6, member_size=MEMBER,
                                            mesh=parallel.make_mesh(n, device="cpu"),
                                            shared_tree=shared_tree)
        assert got == want, n
    if repair:
        # mesh size 8: only the group [8, 9] is inexact
        assert inexact[-6:] == [False, False, False, False, True, False]
    assert gzip.decompress(want) == PAYLOAD
    sharded.serial_fallbacks.clear()
    assert sharded.sharded_gzip_decompress(want, device="cpu") == PAYLOAD
    assert not sharded.serial_fallbacks


def test_mesh_zlib_matches_reference(trim_loop):
    want = ref.sharded_zlib_compress(PAYLOAD, 6, member_size=MEMBER)
    for n in (1, 2, 8):
        assert sharded.sharded_zlib_compress(
            PAYLOAD, 6, member_size=MEMBER,
            mesh=parallel.make_mesh(n, device="cpu")) == want, n
    assert zlib.decompress(want) == PAYLOAD


def test_make_mesh(monkeypatch):
    assert parallel.make_mesh(device="cpu") == (torch.device("cpu"),)
    assert parallel.make_mesh(3, device="cpu") == (torch.device("cpu"),) * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        parallel.make_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        sharded.sharded_gzip_compress(b"x", mesh=("cuda:0",))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert parallel.make_mesh() == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        parallel.make_mesh(2)


def _step_inputs(m, seg):
    rng = np.random.default_rng(0)
    data = np.zeros((m, lz77.HIST + seg), np.uint8)
    data[:, lz77.HIST:] = rng.integers(0, 32, (m, seg), np.uint8)
    nv = np.array([seg - 7 * i for i in range(m)], np.int32)
    return data, nv, np.zeros(m, np.int32), np.ones(m, np.int32)


def test_compress_step_sharded_matches_reference():
    m, seg = 16, 1024
    args = _step_inputs(m, seg)
    want = [np.asarray(a) for a in ref_parallel.compress_step_sharded(
        ref_parallel.make_mesh(8), *args, level=6, seg_len=seg)]
    got = parallel.compress_step_sharded(parallel.make_mesh(8, device="cpu"), *args,
                                         level=6, seg_len=seg)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want] == \
        [(m, (10 * seg) // 32 + 64), (8, m), ()]
    assert [g.dtype for g in got] == [torch.uint32, torch.int32, torch.int32]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    # one device: the batch whole, sizes_all one row
    words, sizes, total = parallel.compress_step_sharded(
        parallel.make_mesh(1, device="cpu"), *args, level=6, seg_len=seg)
    assert torch.equal(words, got[0]) and int(total) == int(got[2])
    np.testing.assert_array_equal(sizes.numpy()[0], want[1][:, :2].reshape(-1))
    with pytest.raises(ValueError, match="does not split"):
        parallel.compress_step_sharded(parallel.make_mesh(3, device="cpu"), *args,
                                       level=6, seg_len=seg)


def test_multihost_index_assembly_matches_single_host():
    data = (b"multihost index determinism " * 3000)[:60000]
    indexed = sharded.sharded_gzip_compress(data, 6, member_size=16384, device="cpu")
    plain, sizes, split_rows, ncmds = sharded.sharded_gzip_compress(
        data, 6, member_size=16384, index=False, return_meta=True, device="cpu")
    assert (plain, sizes, split_rows, ncmds) == ref.sharded_gzip_compress(
        data, 6, member_size=16384, index=False, return_meta=True)
    xt = sharded._build_index(len(sizes), sizes, split_rows, ncmds)
    assert xt is not None
    head0 = bytearray(plain[:10])
    head0[3] |= gz._FEXTRA
    rebuilt = bytes(head0) + xt + plain[10:]
    assert rebuilt == indexed == ref.sharded_gzip_compress(data, 6, member_size=16384)
    assert sharded.sharded_gzip_decompress(rebuilt, device="cpu") == data
    empty = sharded.sharded_gzip_compress(b"", return_meta=True, device="cpu")
    assert empty == ref.sharded_gzip_compress(b"", return_meta=True)


STRIDE = ref.SPLIT_BITS
CAP = 65535  # the TB field's u16 commands a row saturate here


def _split_table(rng, m, counts, *, interleave=False, steps=(1, 3000)):
    """(sizes, [m, N_SPLITS - 1, 3] int64 splits, ncmds) with ``counts[i]``
    valid TB triples in member i (deltas 0..255 off the stride, commands
    rising by ``steps``), first in the row or at drawn slots."""
    s = ref.N_SPLITS - 1
    splits = np.zeros((m, s, 3), np.int64)
    ncmds = np.zeros(m, np.int64)
    for i, k in enumerate(counts):
        slots = np.sort(rng.choice(s, k, replace=False)) if interleave else np.arange(k)
        j = np.arange(1, k + 1)
        splits[i, slots, 0] = j * STRIDE - rng.integers(0, 256, k)
        splits[i, slots, 1] = np.cumsum(rng.integers(*steps, k))
        splits[i, slots, 2] = np.cumsum(rng.integers(1, 9000, k))
        ncmds[i] = (splits[i, slots[-1], 1] if k else 0) + rng.integers(0, 3000)
    sizes = rng.integers(20, 140_000, m)
    return sizes, splits, ncmds


def _index_case(name, rng, monkeypatch):
    """(m, sizes, splits, ncmds) of one drawn case of the index encoder."""
    if name == "tb":
        return 40, *_split_table(rng, 40, rng.integers(1, 250, 40))
    if name == "delta_out_of_range":
        sizes, splits, ncmds = _split_table(rng, 20, rng.integers(1, 60, 20))
        splits[7, 3, 0] = 4 * STRIDE - 256  # delta 256: no TB, the TS subfield
        return 20, sizes, splits, ncmds
    if name == "negative_delta":
        sizes, splits, ncmds = _split_table(rng, 20, rng.integers(1, 60, 20))
        splits[3, 0, 0] = STRIDE + 1
        return 20, sizes, splits, ncmds
    if name == "split_bits_0":
        for mod in (ref, sharded):
            monkeypatch.setattr(mod, "SPLIT_BITS", 0)
        return 25, *_split_table(rng, 25, rng.integers(0, 40, 25))
    if name == "ncmds_none":
        sizes, splits, _ = _split_table(rng, 12, rng.integers(0, 40, 12))
        return 12, sizes, splits, None
    if name == "empty_members":
        counts = rng.integers(1, 50, 30)
        counts[[0, 4, 5, 17, 29]] = 0
        sizes, splits, ncmds = _split_table(rng, 30, counts)
        ncmds[[0, 5]] = 0
        ncmds[4], ncmds[17], ncmds[29] = 1234, CAP, CAP + 77
        return 30, sizes, splits, ncmds
    if name == "interleaved_zeros":
        return 30, *_split_table(rng, 30, rng.integers(0, 120, 30), interleave=True)
    if name == "cmds_cap":
        sizes, splits, ncmds = _split_table(rng, 9, [3, 3, 3, 3, 0, 0, 2, 2, 2])
        splits[0, 1, 1] = splits[0, 0, 1] + CAP  # a step at the cap
        splits[1, 1, 1] = splits[1, 0, 1] + CAP + 1  # and over it
        splits[1, 2, 1] = splits[1, 1, 1] + 5
        splits[2, 0, 1] = CAP + 9  # the first step, from 0
        splits[2, 1:3, 1] = [CAP + 10, CAP + 11]
        ncmds[3] = splits[3, 2, 1] + CAP  # the final step at the cap
        ncmds[4], ncmds[5] = CAP, CAP + 1
        ncmds[6] = splits[6, 1, 1] + CAP + 2  # the final step over it
        ncmds[7] = splits[7, 1, 1] - 5  # a final step below 0 moves nothing
        splits[7, 1, 1] = splits[7, 0, 1] - 3  # nor a falling one
        splits[8, :2, 1], ncmds[8] = [-5, -9], 0  # every step falls: 0
        return 9, sizes, splits, ncmds
    if name in ("ts_at_limit", "ts_over_limit"):
        # 5 * 34 + 12 * 5446 + 13 = 65535: the TS subfield just fits
        counts = np.full(34, 5446 // 34)
        counts[: 5446 - counts.sum() + (name == "ts_over_limit")] += 1
        sizes, splits, ncmds = _split_table(rng, 34, counts)
        splits[0, 0, 0] = STRIDE - 300  # no TB
        return 34, sizes, splits, ncmds
    if name == "tb_too_long":  # nor does TS fit: sizes only
        return 300, *_split_table(rng, 300, np.full(300, 249))
    assert name == "too_many_members"  # no index at all
    m = (65531 - 8) // 4 + 1
    return m, [100] * m, [[(0, 0, 0)] * (ref.N_SPLITS - 1)] * m, [0] * m


@pytest.mark.parametrize("name", [
    "tb", "delta_out_of_range", "negative_delta", "split_bits_0", "ncmds_none",
    "empty_members", "interleaved_zeros", "cmds_cap", "ts_at_limit", "ts_over_limit",
    "tb_too_long", "too_many_members"])
def test_build_index_matches_reference(monkeypatch, name):
    """The array encoder writes the reference's index bytes (or its None),
    from lists of tuples and from int64 arrays alike."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    m, sizes, splits, ncmds = _index_case(name, rng, monkeypatch)
    monkeypatch.setattr(sharded, "INDEX_COUNTS", type(sharded.INDEX_COUNTS)())
    if isinstance(splits, np.ndarray):
        lists = (sizes.tolist(), [list(map(tuple, r)) for r in splits.tolist()],
                 None if ncmds is None else ncmds.tolist())
    else:
        lists = (sizes, splits, ncmds)
    want = ref._build_index(m, *lists)
    assert sharded._build_index(m, *lists) == want
    if isinstance(splits, np.ndarray):
        assert sharded._build_index(m, sizes, splits, ncmds) == want
    kind = {"tb": "tb", "empty_members": "tb", "interleaved_zeros": "tb", "cmds_cap": "tb",
            "tb_too_long": "sizes_only", "ts_over_limit": "sizes_only",
            "too_many_members": "none"}.get(name, "ts")
    calls = 1 + isinstance(splits, np.ndarray)
    assert sharded.INDEX_COUNTS == {kind: calls, "members": calls * m}


def _gathered(rng, total=515, nproc=4):
    """A [nproc, per, width] gather of ``total`` members' rows, the last
    process short, its padding rows junk, and the rows in member order."""
    per = -(-total // nproc)
    sizes, splits, ncmds = _split_table(rng, total, rng.integers(0, 60, total))
    rows = np.concatenate([sizes[:, None], ncmds[:, None], splits.reshape(total, -1)], 1)
    all_meta = rng.integers(1, 1 << 20, (nproc * per, rows.shape[1]))
    all_meta[:total] = rows
    return all_meta.reshape(nproc, per, -1), sizes, splits, ncmds


def test_assemble_index_matches_single_process_writer():
    """515 = 3 * 129 + 128 members gathered from four processes: the
    index ``_assemble_index`` joins is ``_build_index``'s over the same
    rows in member order, and the reference's."""
    rng = np.random.default_rng(515)
    all_meta, sizes, splits, ncmds = _gathered(rng)
    assert all_meta.shape == (4, 129, 2 + 3 * (sharded.N_SPLITS - 1))
    archive = b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\x03" + rng.bytes(5000)
    got = multihost._assemble_index(archive, 515, all_meta)
    lists = (sizes.tolist(), [list(map(tuple, r)) for r in splits.tolist()], ncmds.tolist())
    for xt in (sharded._build_index(515, *lists), ref._build_index(515, *lists)):
        head0 = bytearray(archive[:10])
        head0[3] |= gz._FEXTRA
        assert got == bytes(head0) + xt + archive[10:]


def test_index_counts(monkeypatch):
    """``INDEX_COUNTS``: a TB, a TS and an unindexed archive add one to
    their subfield's key, ``members`` their members."""
    data = (b"index counts, by subfield " * 2000)[:20000]
    monkeypatch.setattr(sharded, "INDEX_COUNTS", type(sharded.INDEX_COUNTS)())
    tb = sharded.sharded_gzip_compress(data, 6, member_size=8192, device="cpu")
    assert dict(sharded.INDEX_COUNTS) == {"tb": 1, "members": 3}
    monkeypatch.setattr(sharded, "SPLIT_BITS", 0)
    ts = sharded.sharded_gzip_compress(data, 6, member_size=8192, device="cpu")
    assert dict(sharded.INDEX_COUNTS) == {"tb": 1, "ts": 1, "members": 6}
    m = (65531 - 8) // 4 + 1
    assert sharded._build_index(m, [1] * m, [[]] * m, [0] * m) is None
    assert dict(sharded.INDEX_COUNTS) == {"tb": 1, "ts": 1, "none": 1, "members": 6 + m}
    monkeypatch.setattr(sharded, "SPLIT_BITS", ref.SPLIT_BITS)
    assert sharded.sharded_gzip_decompress(tb, device="cpu") == data
    assert sharded.sharded_gzip_decompress(ts, device="cpu") == data


def test_codec_config_matches_reference():
    ours = [(f.name, f.default) for f in dataclasses.fields(config.CodecConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(ref_config.CodecConfig)]
    assert ours == [("device", "cuda") if name == "platform" else (name, default)
                    for name, default in theirs]
    assert config.DEFAULT_CONFIG == config.CodecConfig()
    assert config.CodecConfig().validate() == config.CodecConfig()
    for bad in (dict(level=13), dict(level=-1), dict(window_bits=7), dict(window_bits=16),
                dict(queue_capacity=3000)):
        with pytest.raises(ValueError) as want:
            ref_config.CodecConfig(**bad).validate()
        with pytest.raises(ValueError) as got:
            config.CodecConfig(**bad).validate()
        assert str(got.value) == str(want.value)


def test_codec_config_wiring_matches_reference(monkeypatch):
    data = b"config object threading " * 500
    cfg = dict(level=6, segment_size=4096, window_bits=12)
    comp = de.deflate(data, config=config.CodecConfig(**cfg, device="cpu"))
    assert comp == ref_de.deflate(data, config=ref_config.CodecConfig(**cfg))
    assert zlib.decompressobj(-12).decompress(comp) == data  # window honored
    # explicit arguments win over the config
    assert de.deflate(data, 1, dynamic=False, config=config.CodecConfig(**cfg),
                      device="cpu") == ref_de.deflate(
        data, 1, dynamic=False, config=ref_config.CodecConfig(**cfg))
    acfg = dict(level=4, member_size=4096, shared_tree=True, write_index=False)
    arch = sharded.sharded_gzip_compress(data, config=config.CodecConfig(**acfg, device="cpu"))
    assert arch == ref.sharded_gzip_compress(data, config=ref_config.CodecConfig(**acfg))
    assert gzip.decompress(arch) == data
    with pytest.raises(ValueError, match="level must be in 0..12"):
        de.deflate(data, config=config.CodecConfig(level=99, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        de.deflate(data, config=config.CodecConfig())


_WORKER = r"""
import sys
import torch
torch.set_num_threads(1)
from decompress_tpu_torch.parallel import multihost

from decompress_tpu_torch.utils import profiling

init, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
multihost.initialize(init, 2, rank)
multihost.initialize(init, 2, rank)  # idempotent
assert multihost._local_member_range(25) == ((0, 13), (13, 25))[rank]
data = (b"two-process multihost determinism " * 4000)[:100000]
with profiling.tracing() as spans:
    arch = multihost.sharded_gzip_compress_multihost(data, 6, member_size=4096, device="cpu")
with open(out, "wb") as f:
    f.write(arch)
call = next(s for s in spans if s.name == "call" and s.parent == 0)
names = [s.name for s in spans]
assert all(call.start_ns <= s.start_ns <= s.end_ns <= call.end_ns for s in spans)
assert names.count("processes.wait") == 1 and names.count("processes.gather") == 2, names
assert all(s.call == call.call for s in spans), spans
assert {"plan.blocks", "schedule.assemble"} <= set(names)
torch.distributed.destroy_process_group()
"""


def _run_workers(script: str, n: int, tmp_path, *args) -> list:
    """``script`` in ``n`` processes meeting at a ``file://`` rendezvous,
    each given the rendezvous, its rank, its output path and ``args``;
    returns the output paths, by rank, once every process has ended
    with 0."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    init = (tmp_path / "rendezvous").as_uri()
    outs = [tmp_path / f"out{i}.bin" for i in range(n)]
    procs = [subprocess.Popen([sys.executable, "-c", script, init, str(i), str(outs[i]),
                               *map(str, args)],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE)
             for i in range(n)]
    logs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            logs.append(err.decode(errors="replace"))
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * n, logs
    return outs


def test_two_process_multihost_archive(tmp_path):
    arch0, arch1 = (o.read_bytes() for o in _run_workers(_WORKER, 2, tmp_path))
    data = (b"two-process multihost determinism " * 4000)[:100000]
    assert arch0 == arch1
    assert arch0 == sharded.sharded_gzip_compress(data, 6, member_size=4096, device="cpu")
    assert arch0 == ref.sharded_gzip_compress(data, 6, member_size=4096)
    assert sharded.sharded_gzip_decompress(arch0, device="cpu") == data


_WORKER4 = r"""
import json
import sys
import torch
torch.set_num_threads(1)
from decompress_tpu_torch.parallel import multihost
from decompress_tpu_torch.utils import profiling

init, rank, out, n = sys.argv[1], int(sys.argv[2]), sys.argv[3], int(sys.argv[4])
multihost.initialize(init, 4, rank)
data = (b"four-process exchange, member order kept; " * 3000)[:n]
calls = []
for _ in range(2):
    before = dict(multihost.COUNTS)
    with profiling.tracing() as spans:
        arch = multihost.sharded_gzip_compress_multihost(data, 6, member_size=4096,
                                                         device="cpu")
    call = next(s for s in spans if s.name == "call" and s.parent == 0)
    ours = [s for s in spans if s.name.startswith("processes.")]
    assert sorted(s.name for s in ours) == ["processes.gather", "processes.gather",
                                            "processes.index", "processes.wait"], spans
    assert all(call.start_ns <= s.start_ns <= s.end_ns <= call.end_ns
               and s.call == call.call for s in spans), spans
    by_id = {s.id: s for s in spans}
    for s in ours:  # no processes.* span inside another
        p = by_id.get(s.parent)
        while p is not None:
            assert not p.name.startswith("processes."), (s, p)
            p = by_id.get(p.parent)
    calls.append({k: multihost.COUNTS[k] - before.get(k, 0)
                  for k in ("collectives", "sent", "received")})
with open(out, "wb") as f:
    f.write(arch)
with open(out + ".json", "w") as f:
    json.dump(calls, f)
torch.distributed.destroy_process_group()
"""


@pytest.mark.parametrize("n", [3 * 4096 - 700, 7 * 4096 - 1500],
                         ids=["a_process_owns_none", "short_last_rank"])
def test_four_process_exchange(tmp_path, n):
    """3 members over 4 processes (the last owns none), or 7 (the last
    owns one short member): the archive every process holds is the
    single process's and the reference's, each call's exchange is one
    wait, two gathers and one index rebuild, and ``COUNTS`` moves by
    the padded pieces and the metadata rows."""
    outs = _run_workers(_WORKER4, 4, tmp_path, n)
    data = (b"four-process exchange, member order kept; " * 3000)[:n]
    archs = [o.read_bytes() for o in outs]
    want = sharded.sharded_gzip_compress(data, 6, member_size=4096, device="cpu")
    assert archs == [want] * 4
    assert want == ref.sharded_gzip_compress(data, 6, member_size=4096)
    assert sharded.sharded_gzip_decompress(want, device="cpu") == data
    total = -(-n // 4096)
    per = -(-total // 4)
    pieces = [sharded.sharded_gzip_compress(data[lo:lo + per * 4096], 6, member_size=4096,
                                            index=False, device="cpu")
              if lo < n else b"" for lo in range(0, 4 * per * 4096, per * 4096)]
    assert b"".join(pieces) == sharded.sharded_gzip_compress(data, 6, member_size=4096,
                                                             index=False, device="cpu")
    sent = 8 + max(map(len, pieces)) + 8 * per * (2 + 3 * (sharded.N_SPLITS - 1))
    for o in outs:
        counts = json.loads(pathlib.Path(str(o) + ".json").read_text())
        assert counts == [{"collectives": 3, "sent": sent, "received": 3 * sent}] * 2


def test_initialize_single_process_and_errors(monkeypatch, tmp_path):
    for k in multihost._LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    multihost.initialize()
    assert not torch.distributed.is_initialized()
    assert multihost._local_member_range(10) == (0, 10)
    x = (b"one process " * 900)[:9000]
    assert multihost.sharded_gzip_compress_multihost(x, member_size=4096, device="cpu") == \
        sharded.sharded_gzip_compress(x, member_size=4096, device="cpu")
    with pytest.raises(RuntimeError):
        multihost.initialize((tmp_path / "rdv").as_uri(), 2, 7)  # rank past the world
    assert not torch.distributed.is_initialized()


def test_profiling_trace_names_the_sharded_stages(tmp_path):
    """device_trace writes a Chrome trace holding the sharded writer's
    stage spans (the captured programs' dispatch, the chunks' staging and
    the assembly) and an outer span, whose records it keeps."""
    with profiling.device_trace(tmp_path) as prof:
        with profiling.span("outer stage"):
            arch = sharded.sharded_gzip_compress(PAYLOAD[:9000], member_size=MEMBER,
                                                 device="cpu")
    trace = (tmp_path / "trace.json").read_text()
    for name in ("programs.dispatch", "schedule.stage", "schedule.assemble", "outer stage"):
        assert f'"{name}"' in trace, name
    assert prof.spans[-1].name == "outer stage"
    assert gzip.decompress(arch) == PAYLOAD[:9000]
