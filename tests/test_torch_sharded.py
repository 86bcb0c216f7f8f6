"""The sharded gzip archive: the port (``decompress_tpu_torch.parallel``,
plain PyTorch versions of the kernels on the CPU) against the reference
(``decompress_tpu.parallel``, JAX on the CPU).

* archives byte-identical to the reference's at levels 4 and 6, with
  ``SPLIT_BITS`` 4096 and the default 8192, and with ``shared_tree``, on
  an input with a stored (random) member, a run of zeros and a short
  tail member; ``gzip.decompress`` restores each;
* the stage arrays on the way: round A and round B at ``hist = 0``, the
  bit offsets ``off0``/``posbits`` of the plane pack and the split-point
  arrays (bit and command strides) equal the reference's;
* ``_read_index_ex`` reads both index kinds as the reference does;
* ``sharded_gzip_decompress`` restores the port's and the reference's
  archives with the serial route poisoned; an unindexed archive, split
  bits past the members' bodies and a member with a reserved block type
  take the serial route and are counted in ``serial_fallbacks``; both
  ``expand`` routes (the default host expansion and ``expand="device"``)
  and an unknown value restore the archives, as the reference's decode
  with the same ``expand`` does;
* the archives the reference decodes on its device decode through the
  decode kernel's wrapper too, with no serial route: the legacy TS index
  (command-stride triples, at the default stride and at 256), an index
  cut to the member sizes, TS indexes with a bit offset that does not
  increase or an output offset past its member, and TB row maxima all
  zeroed; each member's compacted command stream equals what the
  reference's lockstep ``decode_symbols`` gives for its rows, NOP slots
  dropped; with the group bound lowered, members decode in consecutive
  groups, one launch each;
* after the card decode, a CRC-32 flipped in the first, the last or a
  stored member, a flipped body byte and a TS command count off by one
  take the counted serial route and return the reference's outcome (its
  bytes, or its exception class, module and message);
* a 2^19-byte member whose final split row holds more than 65,535
  commands (the TB index's u16 row maximum saturates): byte-identical to
  the reference's archive and decoded by the counted serial route, as
  the reference decodes it; a row past the decode kernel's bit range is
  routed by the plan, not raised by staging;
* malformed input on the serial route (a truncated gzip, a flipped
  trailer CRC, a bad magic byte, a reserved block type) raises the
  reference's exception class and message (the reference pinned to its
  pure-Python decoder, ``tests/ref_host.py``);
* ``sharded_zlib_compress`` byte-identical to the reference's at levels
  4 and 6 on three 16 KiB members (one stored) and a partial one, and on
  empty input; ``zlib`` and the port's ``zl.inflate`` restore each.
"""

import functools
import gzip
import pathlib
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decompress_tpu import de as ref_de
from decompress_tpu import gz as ref_gz
from decompress_tpu import native as ref_native
from decompress_tpu.ops import bitpack as ref_bitpack
from decompress_tpu.ops import inflate as ref_inflate
from decompress_tpu.ops import lz77 as ref_lz77
from decompress_tpu.parallel import sharded as ref
from decompress_tpu_torch import de, gz, zl
from decompress_tpu_torch.ops import bitpack, inflate_cu, lz77
from decompress_tpu_torch.parallel import sharded
from ref_host import ref_host  # noqa: F401
from torch_archives import sizes_only
from torch_threads import one_torch_thread  # noqa: F401

MEMBER = 4096


def _payload():
    rng = np.random.default_rng(11)
    text = open(__file__, "rb").read()
    return (text[:9000] + rng.integers(0, 256, MEMBER, np.uint8).tobytes()
            + bytes(6000) + text[:1500])


PAYLOAD = _payload()
_ARCHIVES = {}


def _pair(level, split_bits=ref.SPLIT_BITS, shared_tree=False, split_stride=ref.SPLIT_STRIDE,
          payload=PAYLOAD, **kw):
    """(port archive, reference archive) of ``payload`` with the split
    strides patched in both modules, cached per arguments."""
    key = (level, split_bits, shared_tree, split_stride, payload, tuple(sorted(kw.items())))
    if key not in _ARCHIVES:
        with pytest.MonkeyPatch.context() as mp:
            for mod in (ref, sharded):
                mp.setattr(mod, "SPLIT_BITS", split_bits)
                mp.setattr(mod, "SPLIT_STRIDE", split_stride)
            _ARCHIVES[key] = (
                sharded.sharded_gzip_compress(payload, level, member_size=MEMBER,
                                              shared_tree=shared_tree, device="cpu", **kw),
                ref.sharded_gzip_compress(payload, level, member_size=MEMBER,
                                          shared_tree=shared_tree, **kw))
    return _ARCHIVES[key]


def test_constants_match_reference():
    for name in ("N_SPLITS", "SPLIT_STRIDE", "SPLIT_BITS", "INDEX_ID", "SPLIT_ID",
                 "TBITS_ID"):
        assert getattr(sharded, name) == getattr(ref, name), name


@pytest.mark.parametrize("split_bits", [4096, 8192])
@pytest.mark.parametrize("level", [4, 6])
def test_archive_matches_reference(level, split_bits):
    got, want = _pair(level, split_bits)
    assert got == want
    assert gzip.decompress(got) == PAYLOAD
    sizes, splits, tb = sharded._read_index_ex(np.frombuffer(got, np.uint8))
    assert len(sizes) == 6 and tb["bits"] == split_bits
    assert sum(map(len, splits)) > 0


def test_shared_tree_archive_matches_reference():
    got, want = _pair(6, shared_tree=True)
    assert got == want
    assert gzip.decompress(got) == PAYLOAD


def test_empty_and_unindexed_match_reference():
    assert sharded.sharded_gzip_compress(b"", device="cpu") == ref.sharded_gzip_compress(b"")
    got, want = _pair(4, index=False, mtime=7)
    assert got == want


def _member_batch():
    arr = np.frombuffer(PAYLOAD, np.uint8)
    m = -(-arr.size // MEMBER)
    rows = de.batch_rows([arr[i * MEMBER:(i + 1) * MEMBER] for i in range(m)], None, MEMBER,
                         rows=m)
    assert np.array_equal(rows.data, ref._batched_members(arr, MEMBER, 0)[0])
    return rows.data[:4], rows.n_valid[:4]


def test_hist0_analysis_matches_reference():
    """Rounds A and B of the level-6 member batch, with no history."""
    data, n_valid = _member_batch()
    hl = np.zeros(4, np.int32)
    want = ref_lz77.analyze2(jnp.asarray(data), jnp.asarray(n_valid), jnp.asarray(hl),
                             level=6, seg_len=MEMBER, hist=0)
    td, tn, th = (torch.from_numpy(a) for a in (data, n_valid, hl))
    got = lz77.lz77_analyze(td, tn, th, level=6, seg_len=MEMBER, hist=0)
    got = lz77.analyze2_finish(got, td, tn, th, level=6, seg_len=MEMBER, hist=0)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("split_bits,split_stride", [(1024, 2048), (0, 64)])
def test_split_points_match_reference(split_bits, split_stride):
    """The pack's words, totals and split arrays, and the plane pack's
    off0/posbits (the reference's boff/posbits), from the reference's
    own level-6 analysis of the member batch."""
    data, n_valid = _member_batch()
    res = ref_lz77.analyze2(jnp.asarray(data), jnp.asarray(n_valid),
                            jnp.asarray(np.zeros(4, np.int32)), level=6,
                            seg_len=MEMBER, hist=0)
    (hv, hb), tabs, kinds = ref_de.plan_blocks(
        np.asarray(res["hist_lit"]), np.asarray(res["hist_dist"]), n_valid,
        np.ones(4, bool))
    assert kinds.count("dynamic") >= 2
    out_words = (9 * MEMBER) // 32 + 2 * ref_de._HDR_PAD
    (w_words, w_totals), w_splits = ref_de._pack_segments(
        res, jnp.asarray(data), jnp.asarray(hv), jnp.asarray(hb), *tabs, out_words,
        n_splits=ref.N_SPLITS, split_stride=split_stride, split_bits=split_bits)
    tres = lz77.state_from_numpy(res, "cpu")
    (words, totals), splits = de.pack_segments(
        tres, torch.from_numpy(data), hv, hb, *tabs, out_words=out_words,
        n_splits=ref.N_SPLITS, split_stride=split_stride, split_bits=split_bits)
    np.testing.assert_array_equal(words.numpy(), np.asarray(w_words))
    np.testing.assert_array_equal(totals.numpy(), np.asarray(w_totals))
    for g, w in zip(splits, w_splits):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (splits[0] > 0).sum() >= 4  # boundaries really resolved

    # the plane pack's per-position bit offsets feed the split writer
    v01, n01, v23, n23 = (np.array(a) for a in (
        res["length"], res["length"] % 7, res["dist"], res["dist"] % 11))
    hdr = (hv.astype(np.int64), hb)
    eob = (np.ones((4, 1), np.int64), np.full((4, 1), 7, np.int32))
    got = bitpack.pack_slot_planes(
        *(torch.from_numpy(a) for a in (v01, n01, v23, n23, *hdr, *eob)), out_words)
    want = ref_bitpack.pack_slot_planes(
        *(jnp.asarray(a) for a in (v01.astype(np.uint32), n01, v23.astype(np.uint32),
                                   n23, hdr[0].astype(np.uint32), hdr[1],
                                   eob[0].astype(np.uint32), eob[1])), out_words)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))


def test_read_index_matches_reference():
    tb_arch = _pair(6)[0]
    ts_arch = _pair(6, split_bits=0)[1]  # the reference's legacy TS index
    for arch in (tb_arch, ts_arch, _pair(4, index=False, mtime=7)[0]):
        buf = np.frombuffer(arch, np.uint8)
        assert sharded._read_index_ex(buf) == ref._read_index_ex(buf)
    assert sharded._read_index_ex(np.frombuffer(ts_arch, np.uint8))[2] is None
    with pytest.raises(de.MalformedError):
        sharded._read_index_ex(np.zeros(20, np.uint8))


@pytest.fixture
def no_serial(monkeypatch):
    """The serial route fails the test; no member is decoded again."""
    sharded.serial_fallbacks.clear()
    sharded.card_retries.clear()
    monkeypatch.setattr(sharded, "_serial", lambda buf, reason: pytest.fail(
        f"serial route taken: {reason}"))
    yield
    assert not sharded.card_retries


#: the decode's expand= values: the default and its host route, the device
#: route, and an unknown value (the host route, as in the reference)
EXPAND = ["auto", "device", "elsewhere"]


@pytest.fixture
def ref_native_off(monkeypatch):
    """The reference's host library is not loaded here (its in-place build
    has no cross-process guard): its decode takes its device route, which
    returns the same bytes."""
    monkeypatch.setattr(ref_native, "available", lambda: False)


@pytest.mark.parametrize("expand", EXPAND)
@pytest.mark.parametrize("which", [0, 1], ids=["port", "reference"])
@pytest.mark.parametrize("level,split_bits", [(4, 4096), (6, 8192)])
def test_decompress_round_trip(no_serial, ref_native_off, monkeypatch, level, split_bits,
                               which, expand):
    arch = _pair(level, split_bits)[which]
    routes = []
    for name in ("_expand_native", "_expand_device"):
        fn = getattr(sharded, name)
        monkeypatch.setattr(sharded, name, lambda *a, fn=fn, name=name: (
            routes.append(name), fn(*a))[1])
    assert sharded.sharded_gzip_decompress(arch, expand=expand, device="cpu") == PAYLOAD
    if expand == "auto":
        assert sharded.sharded_gzip_decompress(arch, device="cpu") == PAYLOAD
    assert set(routes) == {"_expand_device" if expand == "device" else "_expand_native"}
    assert ref.sharded_gzip_decompress(arch, expand=expand) == PAYLOAD
    assert not sharded.serial_fallbacks


def _with_tb(stride: int | None = None, max_cmds: int | None = None) -> bytes:
    """The level-6 port archive with its TB split stride, or every
    member's recorded command capacity, replaced."""
    arch = bytearray(_pair(6)[0])
    tb = 16 + int.from_bytes(arch[14:16], "little")  # after the TZ subfield
    assert arch[tb: tb + 2] == b"TB"
    if stride is not None:
        arch[tb + 4: tb + 8] = stride.to_bytes(4, "little")
    j, end = tb + 8, tb + 4 + int.from_bytes(arch[tb + 2: tb + 4], "little")
    while max_cmds is not None and j < end:
        cnt = int.from_bytes(arch[j: j + 2], "little")
        arch[j + 2: j + 4] = max_cmds.to_bytes(2, "little")
        j += 4 + cnt
    return bytes(arch)


def test_serial_route_is_counted(ref_host):
    """What the host finds before staging takes the serial route, counted."""
    sharded.serial_fallbacks.clear()
    unindexed = _pair(4, index=False, mtime=7)[0]
    # split bits far past every member's body
    far = _with_tb(stride=(1 << 31) - 1)
    for arch, reason in ((unindexed, "no member index"),
                         (far, "split bits past a member's body")):
        assert sharded.sharded_gzip_decompress(arch, device="cpu") == PAYLOAD
        assert sharded.serial_fallbacks[reason] == 1, dict(sharded.serial_fallbacks)
    # the first member's block type set to the reserved 3: the host
    # decoder rejects it as the reference's does
    bad_type = bytearray(_pair(6)[0])
    bad_type[gz._header_end(np.frombuffer(bytes(bad_type), np.uint8))] |= 0b110
    with pytest.raises(de.MalformedError, match="^invalid kind of block$"):
        sharded.sharded_gzip_decompress(bytes(bad_type), device="cpu")
    with pytest.raises(ref_de.MalformedError, match="^invalid kind of block$"):
        ref.sharded_gzip_decompress(bytes(bad_type))
    assert sharded.serial_fallbacks["member not device-decodable"] == 1
    assert sum(sharded.serial_fallbacks.values()) == 3


def _edit_ts(arch: bytes, member: int, k: int, field: int, fn) -> bytes:
    """The TS archive with field ``field`` (0 bit offset, 1 command index,
    2 output offset) of member ``member``'s k-th triple replaced by
    fn(old value)."""
    a = bytearray(arch)
    ts = 16 + int.from_bytes(a[14:16], "little")  # after the TZ subfield
    assert a[ts: ts + 2] == b"TS"
    j = ts + 5  # past the id, the length and N_SPLITS
    for _ in range(member):
        j += 1 + 12 * a[j]
    assert k < a[j]
    o = j + 1 + 12 * k + 4 * field
    a[o: o + 4] = fn(int.from_bytes(a[o: o + 4], "little")).to_bytes(4, "little")
    return bytes(a)


def _card_archive(name: str) -> bytes:
    """Archives the card decodes as the reference's device does: the TS
    index at the default command stride (one triple) and at 256 (29
    triples), no split subfield, a TS index whose second triple's bit
    offset does not increase, one whose output offset passes its member,
    and the TB index with every row maximum zeroed."""
    ts256 = _pair(6, split_bits=0, split_stride=256)[0]
    return {"ts": lambda: _pair(6, split_bits=0)[0],
            "ts_stride_256": lambda: ts256,
            "sizes_only": lambda: sizes_only(_pair(6)[0]),
            "ts_not_increasing": lambda: _edit_ts(ts256, 0, 1, 0, lambda b: 3),
            "ts_out_past_isize": lambda: _edit_ts(ts256, 2, 0, 2, lambda o: 1 << 20),
            "tb_zero_max": lambda: _with_tb(max_cmds=0)}[name]()


CARD_ARCHIVES = ["ts", "ts_stride_256", "sizes_only", "ts_not_increasing",
                 "ts_out_past_isize"]


@pytest.mark.parametrize("expand", EXPAND[:2])
@pytest.mark.parametrize("name", CARD_ARCHIVES)
def test_every_index_decodes_on_card_route(no_serial, ref_native_off, monkeypatch, name,
                                           expand):
    """TS, sizes-only and corrupt split indexes decode through the decode
    kernel's wrapper in one launch, to the reference's bytes: TS rows
    between the triples' bit offsets, each checked against its count, the
    others one row a member."""
    arch = _card_archive(name)
    buf = np.frombuffer(arch, np.uint8)
    assert gzip.decompress(arch) == PAYLOAD
    assert sharded._read_index_ex(buf) == ref._read_index_ex(buf)
    plan = sharded.decode_plan(buf)
    split = name in ("ts", "ts_stride_256")
    assert any(len(r) > 1 for r in plan.rows) == split
    assert any(c > 0 for r in plan.counts for c in r) == split
    if name == "sizes_only":
        assert sharded._read_index_ex(buf)[1] is None
    if not split:  # isize + 2, and no more than the row's bits + 2
        assert plan.caps == [min(plan.metas[i][3], plan.metas[i][1].size * 8 - r[0][0]) + 2
                             for i, r in zip(plan.huff, plan.rows)]
    launches = []
    decode = inflate_cu.decode
    monkeypatch.setattr(inflate_cu, "decode", lambda *a: (launches.append(1), decode(*a))[1])
    assert sharded.sharded_gzip_decompress(arch, expand=expand, device="cpu") == PAYLOAD
    assert len(launches) == 1 and not sharded.serial_fallbacks
    assert ref.sharded_gzip_decompress(arch, expand=expand) == PAYLOAD


@pytest.mark.parametrize("expand", EXPAND[:2])
def test_zeroed_row_maxima_decode_on_card_route(no_serial, ref_native_off, expand):
    """A TB index whose row maxima are all 0 is still valid gzip: its rows
    take the cap isize + 2, at most their bits + 2, and decode on the card,
    as the reference's do."""
    arch = _card_archive("tb_zero_max")
    plan = sharded.decode_plan(np.frombuffer(arch, np.uint8))
    bits = [[(b or plan.metas[i][1].size * 8) - a for a, b in r]
            for i, r in zip(plan.huff, plan.rows)]
    assert plan.caps == [min(plan.metas[i][3], max(n)) + 2 for i, n in zip(plan.huff, bits)]
    assert any(len(r) > 1 for r in plan.rows)
    assert sharded.sharded_gzip_decompress(arch, expand=expand, device="cpu") == PAYLOAD
    assert ref.sharded_gzip_decompress(arch, expand=expand) == PAYLOAD


@pytest.mark.parametrize("name", CARD_ARCHIVES + ["tb_zero_max"])
def test_command_streams_match_reference_decode_symbols(ref_native_off, monkeypatch, name):
    """Each member's compacted command stream == what the reference's
    lockstep decoder ``decode_symbols`` gives for its rows (count-stopped
    for TS, to end-of-block for whole members), NOP slots dropped."""
    arch = _card_archive(name)
    got = []
    expand_native = sharded._expand_native

    def port_spy(flat, bounds, isizes, crcs):
        b = bounds.tolist()
        got.extend(flat[b[k]: b[k + 1]].tolist() for k in range(len(isizes)))
        return expand_native(flat, bounds, isizes, crcs)

    monkeypatch.setattr(sharded, "_expand_native", port_spy)
    calls = []
    decode_symbols = ref_inflate.decode_symbols

    def ref_spy(*a, **kw):
        calls.append((decode_symbols(*a, **kw), kw))
        return calls[-1][0]

    monkeypatch.setattr(ref_inflate, "decode_symbols", ref_spy)
    assert sharded.sharded_gzip_decompress(arch, device="cpu") == PAYLOAD
    assert ref.sharded_gzip_decompress(arch, expand="device") == PAYLOAD
    [((kinds, values, dists, ok), kw)] = calls
    members = np.asarray(kw["row_members"])
    assert np.asarray(ok)[members < len(got)].all()  # the reference's device decode held
    stops = kw["stop_counts"] if kw["stop_counts"] is not None else kw["stop_bits"]
    stops = np.zeros(kinds.shape[0], np.int64) if stops is None else np.asarray(stops)
    packed = ((np.asarray(kinds).astype(np.int64) << 26) | (np.asarray(dists) << 10)
              | np.asarray(values))
    members = np.asarray(kw["row_members"])
    want = [[] for _ in got]
    for row, m in enumerate(members):
        if m >= len(got):
            continue  # a padding row
        slots = [int(s) for s in packed[row] if s >> 26 != 3]
        end = next(j for j, s in enumerate(slots) if s >> 26 == 2)
        want[m] += slots[: end + (stops[row] == 0)]
    assert len(got) == 6 and got == want


STORED_PAYLOAD = np.random.default_rng(13).integers(0, 256, MEMBER, np.uint8).tobytes() \
    + PAYLOAD[:3000]


def _flip(arch: bytes, at: int) -> bytes:
    out = bytearray(arch)
    out[at] ^= 1
    return bytes(out)


def _reject(case: str) -> tuple:
    """(archive, serial reason) of an archive the card decode rejects:
    the first or the last member's CRC-32, a byte in the middle of the
    first member's body, a stored member's CRC-32 (the payload's first
    member is random), or a TS triple's command index one too high."""
    arch = _pair(6)[0]
    sizes = sharded._read_index_ex(np.frombuffer(arch, np.uint8))[0]
    mismatch = "member length or CRC-32 mismatch"
    if case == "first_crc":
        return _flip(arch, sizes[0] - 5), mismatch
    if case == "last_crc":
        return _flip(arch, sum(sizes) - 5), mismatch
    if case == "body_byte":
        body = gz._header_end(np.frombuffer(arch, np.uint8))
        return _flip(arch, body + (sizes[0] - body - 8) // 2), mismatch
    if case == "stored_crc":
        stored = _pair(6, payload=STORED_PAYLOAD)[0]
        metas = sharded.decode_plan(np.frombuffer(stored, np.uint8)).metas
        assert metas[0][0][0] == "stored"
        return _flip(stored, sharded._read_index_ex(np.frombuffer(stored, np.uint8))[0][0] - 5), \
            mismatch
    assert case == "ts_count"
    ts256 = _pair(6, split_bits=0, split_stride=256)[0]
    return _edit_ts(ts256, 0, 0, 1, lambda c: c + 1), "card decode rejected a row"


def _outcome(fn, buf):
    """("bytes", output) or the exception's module tail, class and message."""
    try:
        return "bytes", fn(buf)
    except Exception as e:  # noqa: BLE001 -- the outcome is compared whatever it is
        return type(e).__module__.rsplit(".", 1)[-1], type(e).__name__, str(e)


@pytest.mark.parametrize("expand", EXPAND[:2])
@pytest.mark.parametrize("case", ["first_crc", "last_crc", "body_byte", "stored_crc",
                                  "ts_count"])
def test_card_decode_failure_raises(ref_host, case, expand):
    """After the card decode, a rejected row, a TS row off its recorded
    count or a member whose length or CRC-32 does not match gives the
    reference's outcome, as it decodes such an archive again serially:
    the same bytes, or the same exception class, module and message.
    The rejected members decode again on the card, each as one row to its
    end-of-block, counted once under the reject's reason; what that
    still rejects, and a stored member that does not match, raises the
    serial route's error, counted once under the same reason."""
    buf, reason = _reject(case)
    sharded.serial_fallbacks.clear()
    sharded.card_retries.clear()
    got = _outcome(lambda b: sharded.sharded_gzip_decompress(b, expand=expand, device="cpu"),
                   buf)
    assert got == _outcome(lambda b: ref.sharded_gzip_decompress(b, expand=expand), buf)
    assert sharded.card_retries == ({} if case == "stored_crc" else {reason: 1})
    assert sharded.serial_fallbacks == ({} if case == "ts_count" else {reason: 1})
    if case == "ts_count":
        assert got == ("bytes", PAYLOAD)  # still valid gzip, decoded whole on the card
    elif case != "body_byte":
        assert got == ("gz", "MalformedError", "invalid checksum")


def _faulty_decode(monkeypatch, fault: str | None = None, calls: int | None = None):
    """inflate_cu.decode with ``fault`` planted in its first ``calls``
    results (every result for None): "not_ok" rejects every row, "cmds"
    flips the low bit of every row's first command (a literal's byte or a
    copy's length), None plants nothing.  Returns the list of each call's
    max_cmds."""
    decode, seen = inflate_cu.decode, []

    def faulty(*a):
        cmds, ok, ncmds = decode(*a)
        seen.append(a[7])
        if fault and (calls is None or len(seen) <= calls):
            if fault == "not_ok":
                ok = torch.zeros_like(ok)
            else:
                cmds = cmds.clone()
                cmds[:, 0] ^= 1
        return cmds, ok, ncmds

    monkeypatch.setattr(inflate_cu, "decode", faulty)
    return seen


@pytest.mark.parametrize("expand", EXPAND[:2])
@pytest.mark.parametrize("fault", ["not_ok", "cmds"])
def test_card_fault_on_good_archive_raises(monkeypatch, fault, expand):
    """A decode that rejects rows or returns wrong commands on a good
    archive, also on the members' second decode as whole-member rows, is
    never replaced by the host decode: the serial route, asked for the
    reference's error, decodes the archive, so CardFault is raised."""
    seen = _faulty_decode(monkeypatch, fault, None)
    reason = {"not_ok": "card decode rejected a row",
              "cmds": "member length or CRC-32 mismatch"}[fault]
    sharded.serial_fallbacks.clear()
    sharded.card_retries.clear()
    with pytest.raises(sharded.CardFault, match="the host decoder accepts the archive"):
        sharded.sharded_gzip_decompress(_pair(6)[0], expand=expand, device="cpu")
    assert sharded.card_retries == {reason: 1} and sharded.serial_fallbacks == {reason: 1}
    assert len(seen) == 2


@pytest.mark.parametrize("expand", EXPAND[:2])
@pytest.mark.parametrize("fault", ["not_ok", "cmds"])
def test_card_fault_once_decodes_whole_members_on_card(monkeypatch, fault, expand):
    """A fault in the first decode only: the rejected members decode again
    on the card as whole-member rows, to the payload, with no serial
    route; the second launch holds only whole-member rows."""
    seen = _faulty_decode(monkeypatch, fault, 1)
    stage, staged = inflate_cu.stage, []
    monkeypatch.setattr(inflate_cu, "stage", lambda *a: (staged.append(a[3]), stage(*a))[1])
    sharded.serial_fallbacks.clear()
    sharded.card_retries.clear()
    assert sharded.sharded_gzip_decompress(_pair(6)[0], expand=expand, device="cpu") == PAYLOAD
    assert len(seen) == 2 and any(len(r) > 1 for r in staged[0])
    assert all(len(r) == 1 and r[0][1] == 0 for r in staged[1])
    reason = {"not_ok": "card decode rejected a row",
              "cmds": "member length or CRC-32 mismatch"}[fault]
    assert sharded.card_retries == {reason: 1} and not sharded.serial_fallbacks


@pytest.mark.parametrize("expand", EXPAND[:2])
@pytest.mark.parametrize("index", ["tb", "sizes_only"])
def test_overstated_isize_sizes_small_buffers(ref_host, monkeypatch, index, expand):
    """One member's trailer isize with its high byte flipped (4,096 ->
    16,781,312 bytes): no row holds more commands than its bits + 2, so
    the command buffer stays within the archive's bits, and the outcome is
    the reference's serial route's, its error for a size mismatch, as
    the reference's device decode rejects the member."""
    arch = _pair(6)[0] if index == "tb" else sizes_only(_pair(6)[0])
    sizes = sharded._read_index_ex(np.frombuffer(arch, np.uint8))[0]
    bad = bytearray(arch)
    bad[sizes[0] - 1] ^= 1  # the first member's isize, bits 24-31
    bad = bytes(bad)
    seen = _faulty_decode(monkeypatch)
    sharded.serial_fallbacks.clear()
    sharded.card_retries.clear()
    got = _outcome(lambda b: sharded.sharded_gzip_decompress(b, expand=expand, device="cpu"),
                   bad)
    assert got == _outcome(ref_gz.decompress, bad) and got[1] == "MalformedError"
    if index == "tb":  # the reference's caps here come from the TB field
        assert got == _outcome(lambda b: ref.sharded_gzip_decompress(b, expand=expand), bad)
    assert seen and max(seen) <= 8 * len(bad)
    mismatch = "member length or CRC-32 mismatch"
    assert sharded.card_retries == {mismatch: 1} and sharded.serial_fallbacks == {mismatch: 1}


def test_groups_split_the_decode(no_serial, monkeypatch):
    """With the group bound lowered to two rows at the largest cap, the
    sizes-only archive's members decode in consecutive groups, one launch
    each, to the same bytes on both routes."""
    arch = _card_archive("sizes_only")
    plan = sharded.decode_plan(np.frombuffer(arch, np.uint8))
    monkeypatch.setattr(sharded, "GROUP_BYTES", 2 * (max(plan.caps) + 4) * 4)
    groups = sharded._groups(plan)
    assert len(groups) >= 3 and [g[0] for g in groups[1:]] == [g[1] for g in groups[:-1]]
    assert groups[0][0] == 0 and groups[-1][1] == len(plan.huff)
    launches = []
    decode = inflate_cu.decode
    monkeypatch.setattr(inflate_cu, "decode", lambda *a: (launches.append(1), decode(*a))[1])
    for expand in EXPAND[:2]:
        launches.clear()
        assert sharded.sharded_gzip_decompress(arch, expand=expand, device="cpu") == PAYLOAD
        assert len(launches) == len(groups)


@functools.cache
def _long_row_pair():
    """(input, port archive, reference archive) of one 2^19-byte member
    of random lowercase letters: its final split row holds more than
    65,535 commands, so the TB index's u16 row maximum saturates."""
    x = np.random.default_rng(0).integers(97, 123, 1 << 19, dtype=np.uint8).tobytes()
    return (x, sharded.sharded_gzip_compress(x, 4, member_size=1 << 19, device="cpu"),
            ref.sharded_gzip_compress(x, 4, member_size=1 << 19))


def test_saturated_row_count_takes_serial_route():
    """The row maximum recorded as the u16 cap is unknown, not a size:
    the archive decodes by the counted serial route, as the reference
    decodes it, and is byte-identical to the reference's."""
    x, arch, want = _long_row_pair()
    assert arch == want and zlib.decompress(arch, 31) == x
    sharded.serial_fallbacks.clear()
    assert sharded.sharded_gzip_decompress(arch, device="cpu") == x
    assert sharded.serial_fallbacks == {"row command count over the index's u16 cap": 1}
    assert ref.sharded_gzip_decompress(arch) == x
    buf = np.frombuffer(arch, np.uint8)
    assert sharded._read_index_ex(buf)[2]["max_cmds"] == [sharded.TB_CMDS_CAP]
    with pytest.raises(sharded._Serial, match="u16 cap"):
        sharded.decode_plan(buf)


def test_row_past_kernel_bit_range_is_routed(monkeypatch):
    """A row longer than the decode kernel's int32 bit range is routed
    by the plan before anything is staged, not raised by ``stage``: the
    bound is lowered below the archive's 502,339-bit final row, since a
    real row of 2^30 bits needs a member body over 2^27 bytes."""
    x, arch, _ = _long_row_pair()
    buf = np.frombuffer(arch, np.uint8)
    monkeypatch.setattr(inflate_cu, "MAX_ROW_BITS", 500_000)
    with pytest.raises(sharded._Serial, match="bit range"):
        sharded.decode_plan(buf)
    monkeypatch.setattr(inflate_cu, "stage", lambda *a: pytest.fail("staged"))
    sharded.serial_fallbacks.clear()
    assert sharded.sharded_gzip_decompress(arch, device="cpu") == x
    assert sharded.serial_fallbacks == {"row longer than the decode kernel's bit range": 1}


def _serial_malformed():
    a = gzip.compress(PAYLOAD[:9000], mtime=0)
    flipped = bytearray(a)
    flipped[-8] ^= 1  # the trailer's CRC-32
    return {"truncated": a[:-20], "trailer_crc": bytes(flipped),
            "magic": b"\x1f\x8c" + a[2:]}


SERIAL_MALFORMED = _serial_malformed()


@pytest.mark.parametrize("name", sorted(SERIAL_MALFORMED))
def test_serial_route_raises_reference_error(ref_host, name):
    """The serial route decodes with the port's host decoder: a malformed
    archive raises the reference's exception class and message, never
    ``zlib.error``."""
    buf = SERIAL_MALFORMED[name]

    def outcome(fn):
        with pytest.raises(Exception) as ei:
            fn(buf)
        e = ei.value
        return type(e).__module__.rsplit(".", 1)[-1], type(e).__name__, str(e)

    sharded.serial_fallbacks.clear()
    got = outcome(lambda b: sharded.sharded_gzip_decompress(b, device="cpu"))
    assert got == outcome(ref.sharded_gzip_decompress)
    assert got[1] == "MalformedError"
    assert sum(sharded.serial_fallbacks.values()) == 1


def _zlib_payload():
    rng = np.random.default_rng(12)
    text = (pathlib.Path(__file__).parent / "corpus" / "book1").read_bytes()
    return (text[:16384] + rng.integers(0, 256, 16384, np.uint8).tobytes()
            + text[-16384:] + text[:5000])


ZLIB_PAYLOAD = _zlib_payload()


@pytest.mark.parametrize("level", [4, 6])
def test_sharded_zlib_matches_reference(level):
    got = sharded.sharded_zlib_compress(ZLIB_PAYLOAD, level, member_size=16384, device="cpu")
    assert got == ref.sharded_zlib_compress(ZLIB_PAYLOAD, level, member_size=16384)
    assert zlib.decompress(got) == ZLIB_PAYLOAD
    assert zl.inflate(got) == ZLIB_PAYLOAD


def test_sharded_zlib_empty_and_member_options_match_reference():
    assert sharded.sharded_zlib_compress(b"", device="cpu") == ref.sharded_zlib_compress(b"")
    assert zlib.decompress(sharded.sharded_zlib_compress(b"", 1, device="cpu")) == b""
    arr = np.frombuffer(ZLIB_PAYLOAD, np.uint8)
    flags = np.array([False, True, False, True])
    parts, n_valid = sharded._compress_members(arr, 4, 16384, (torch.device("cpu"),),
                                               final_flags=flags, want_crc=False)
    assert all(p.crc is None for p in parts)
    assert n_valid.tolist() == [16384, 16384, 16384, 5000]
    assert [p.kind for p in parts] == ["packed", "stored", "packed", "packed"]
    # BFINAL of each packed member follows its flag
    assert [int(p.data[0]) & 1 for p in parts if p.kind == "packed"] == [0, 0, 1]
