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
  archives with the serial route poisoned; an unindexed archive, a
  legacy command-stride index, split bits past the members' bodies and a
  member with a reserved block type take the serial route and are counted
  in ``serial_fallbacks``; a row the decode rejects and a corrupt member
  CRC raise without it; both ``expand`` routes (the default host
  expansion and ``expand="device"``) and an unknown value restore the
  archives, as the reference's decode with the same ``expand`` does;
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
from decompress_tpu import native as ref_native
from decompress_tpu.ops import bitpack as ref_bitpack
from decompress_tpu.ops import lz77 as ref_lz77
from decompress_tpu.parallel import sharded as ref
from decompress_tpu_torch import de, gz, zl
from decompress_tpu_torch.ops import bitpack, inflate_cu, lz77
from decompress_tpu_torch.parallel import sharded
from ref_host import ref_host  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

MEMBER = 4096


def _payload():
    rng = np.random.default_rng(11)
    text = open(__file__, "rb").read()
    return (text[:9000] + rng.integers(0, 256, MEMBER, np.uint8).tobytes()
            + bytes(6000) + text[:1500])


PAYLOAD = _payload()
_ARCHIVES = {}


def _pair(level, split_bits=ref.SPLIT_BITS, shared_tree=False, **kw):
    """(port archive, reference archive) with the split stride patched in
    both modules, cached per arguments."""
    key = (level, split_bits, shared_tree, tuple(sorted(kw.items())))
    if key not in _ARCHIVES:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ref, "SPLIT_BITS", split_bits)
            mp.setattr(sharded, "SPLIT_BITS", split_bits)
            _ARCHIVES[key] = (
                sharded.sharded_gzip_compress(PAYLOAD, level, member_size=MEMBER,
                                              shared_tree=shared_tree, device="cpu", **kw),
                ref.sharded_gzip_compress(PAYLOAD, level, member_size=MEMBER,
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
    data, n_valid = sharded._batched_members(np.frombuffer(PAYLOAD, np.uint8), MEMBER, 0)
    assert np.array_equal(data, ref._batched_members(
        np.frombuffer(PAYLOAD, np.uint8), MEMBER, 0)[0])
    return data[:4], n_valid[:4]


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
    sharded.serial_fallbacks.clear()
    monkeypatch.setattr(sharded, "_serial", lambda buf, reason: pytest.fail(
        f"serial route taken: {reason}"))


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
    ts = _pair(6, split_bits=0)[1]
    # split bits far past every member's body
    far = _with_tb(stride=(1 << 31) - 1)
    for arch, reason in ((unindexed, "no member index"),
                         (ts, "no bit-stride split index"),
                         (far, "corrupt split index")):
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
    assert sum(sharded.serial_fallbacks.values()) == 4


@pytest.mark.parametrize("expand", EXPAND[:2])
def test_card_decode_failure_raises(no_serial, expand):
    """After the decode has run, a rejected row or a CRC-32 mismatch
    raises on either expand route and is never decoded again on the host."""
    # a command capacity of 0 recorded for every member: no row finishes
    with pytest.raises(de.MalformedError, match="invalid stream"):
        sharded.sharded_gzip_decompress(_with_tb(max_cmds=0), expand=expand, device="cpu")
    sizes = sharded._read_index_ex(np.frombuffer(_pair(6)[0], np.uint8))[0]
    for end in (sizes[0], sum(sizes)):  # the first and the last member's CRC-32
        bad_crc = bytearray(_pair(6)[0])
        bad_crc[end - 5] ^= 1
        with pytest.raises(de.MalformedError, match="CRC-32"):
            sharded.sharded_gzip_decompress(bytes(bad_crc), expand=expand, device="cpu")
    assert not sharded.serial_fallbacks


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
    parts, n_valid, crcs = sharded._compress_members(arr, 4, 16384, (torch.device("cpu"),),
                                                     final_flags=flags, want_crc=False)
    assert crcs is None and n_valid.tolist() == [16384, 16384, 16384, 5000]
    assert [p[0] for p in parts] == ["packed", "stored", "packed", "packed"]
    # BFINAL of each packed member follows its flag
    assert [int(p[1][0]) & 1 for p in parts if p[0] == "packed"] == [0, 0, 1]
