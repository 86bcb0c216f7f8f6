"""The port's member-parallel decode stages against the reference's, on
the CPU.

* ``inflate.prepare_member`` == the reference's on dynamic, fixed,
  stored, multi-block and malformed member bodies;
* ``inflate_cu.build_row_tables`` == ``inflate_pl.build_row_tables``
  entry for entry on random valid code lengths and on the fixed and
  incomplete trees;
* ``inflate_cu.decode_plain`` (what ``decode`` runs on a CPU tensor) ==
  the reference's Pallas decoder ``inflate_pl.decode_symbols_pl`` in
  interpret mode, row by row, after its NOP slots are stripped, on an
  archive of the reference's; and with a flipped bit, both reject the
  damaged row;
* ``slot_counts_bits``, ``compact_commands`` and ``expand_commands`` ==
  the reference's on the decoded command stream.
Exact equality throughout (integers).
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decompress_tpu import de as ref_de
from decompress_tpu.core import huffman as ref_huffman
from decompress_tpu.core import tables as ref_tables
from decompress_tpu.ops import inflate as ref_inflate
from decompress_tpu.ops import inflate_pl
from decompress_tpu.parallel import sharded as ref_sharded
from decompress_tpu_torch.ops import inflate, inflate_cu
from decompress_tpu_torch.parallel import sharded


def test_table_constants_match_reference():
    for name in ("ROOT_BITS", "ROOT_SIZE", "SUB_BITS", "SUB_SLOTS", "LITSUB_SIZE",
                 "DISTSUB_SIZE", "CLS_INVALID", "CLS_LIT", "CLS_LEN", "CLS_EOB",
                 "CLS_SUB"):
        assert getattr(inflate_cu, name) == getattr(inflate_pl, name), name


def _raw(data, level, strategy=zlib.Z_DEFAULT_STRATEGY):
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 9, strategy)
    return np.frombuffer(c.compress(data) + c.flush(), np.uint8)


@pytest.mark.parametrize("kind", ["dynamic", "fixed", "stored", "multi", "malformed"])
def test_prepare_member_matches_reference(kind):
    x = open(__file__, "rb").read() * 3
    body = {"dynamic": _raw(x, 6), "fixed": _raw(x[:3000], 6, zlib.Z_FIXED),
            "stored": _raw(x[:70_000], 0), "multi": _raw(x * 40, 1),
            "malformed": _raw(x, 6).copy()}[kind]
    if kind == "malformed":
        body[0] = (body[0] & 7) | (31 << 3)  # HLIT > 286
    try:
        want = ref_inflate.prepare_member(body)
    except (ref_inflate.NotParallelizable, ref_de.MalformedError) as e:
        err = inflate.NotParallelizable if isinstance(
            e, ref_inflate.NotParallelizable) else inflate.de.MalformedError
        with pytest.raises(err):
            inflate.prepare_member(body)
        assert kind in ("multi", "malformed")
        return
    got = inflate.prepare_member(body)
    assert got[0] == want[0] == ("stored" if kind == "stored" else "huff")
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


def _random_lens(rng, nsym, maxlen=15):
    freqs = rng.integers(0, 1000, nsym).astype(np.int64)
    freqs[rng.integers(0, nsym)] += 10000  # skew for length spread
    return np.asarray(ref_huffman.code_lengths_from_frequencies(freqs, max_length=maxlen),
                      np.int32)


def _length_sets():
    rng = np.random.default_rng(0)
    ll = np.zeros((6, 288), np.int32)
    dl = np.zeros((6, 32), np.int32)
    for i in range(4):
        ll[i, :286] = _random_lens(rng, 286)
        dl[i, :30] = _random_lens(rng, 30)
    ll[4] = ref_tables.FIXED_LIT_LENGTHS      # pure-root tree
    dl[4] = ref_tables.FIXED_DIST_LENGTHS
    ll[5, :286] = _random_lens(rng, 286, maxlen=9)
    dl[5, 0] = 1                               # one-code (incomplete) tree
    return ll, dl


def test_build_row_tables_matches_reference():
    ll, dl = _length_sets()
    got = inflate_cu.build_row_tables(torch.from_numpy(ll), torch.from_numpy(dl))
    want = inflate_pl.build_row_tables(jnp.asarray(ll), jnp.asarray(dl))
    assert any(((t.numpy() >> 24) == inflate_cu.CLS_SUB).any() for t in got[:4])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_tables_fit_matches_build_ok():
    """The host check that routes deep trees to the serial route agrees
    with the table build's own overflow flag."""
    ll, dl = _length_sets()
    deep = np.zeros(288, np.int32)
    deep[:119], deep[119:263] = 7, 11  # 72 distinct 10-bit prefixes > 64
    ll = np.vstack([ll, deep])
    dl = np.vstack([dl, dl[:1]])
    ok = inflate_cu.build_row_tables(torch.from_numpy(ll), torch.from_numpy(dl))[4]
    assert ok.tolist() == [True] * 6 + [False]
    assert [inflate_cu.tables_fit(a, b) for a, b in zip(ll, dl)] == ok.tolist()


@pytest.fixture
def archive(monkeypatch):
    """A reference archive of 6 members (dynamic, stored, a run of
    zeros, a short tail) with splits every 1024 bits: several rows per
    member, and few enough commands per row for interpret mode."""
    monkeypatch.setattr(ref_sharded, "SPLIT_BITS", 1024)
    rng = np.random.default_rng(5)
    payload = (b"the decode kernel must agree with the reference's " * 120
               + rng.integers(0, 256, 3000, np.uint8).tobytes() + b"\x00" * 3000)
    return payload, np.frombuffer(
        ref_sharded.sharded_gzip_compress(payload, 6, member_size=2048), np.uint8)


def _norm_rows(kinds, values, dists, stops):
    """Per row: the real command tuples, NOP slots (kind 3) stripped;
    interior rows up to their first end filler, final rows up to and
    including the end-of-block."""
    out = []
    for r in range(len(stops)):
        cmds = []
        for k, v, d in zip(kinds[r], values[r], dists[r]):
            if k == 3:
                continue
            if k == 2:
                if stops[r] == 0:
                    cmds.append((2, 0, 0))
                break
            cmds.append((int(k), int(v), int(d)))
        out.append(cmds)
    return out


def _reference_decode(metas, huff, rows, max_cmds):
    """The reference's Pallas decoder (interpret mode) on the same rows.
    Its word window and unroll, which shape only its NOP slots, are cut
    to keep the interpret-mode compile short."""
    m = len(huff)
    wmax = max(metas[i][1].size for i in huff) // 4 + 4
    mw = np.zeros((m + 1, wmax), np.uint32)
    ll = np.zeros((m + 1, 288), np.int32)
    dl = np.zeros((m + 1, 32), np.int32)
    flat = []
    for k, i in enumerate(huff):
        (_, lit, dist, _), body, _, _ = metas[i]
        words = np.zeros(wmax * 4, np.uint8)
        words[: body.size] = body
        mw[k], ll[k], dl[k] = words.view("<u4"), lit, dist
        flat += [(k, start, stop, (stop or body.size * 8) - start)
                 for start, stop in rows[k]]
    rm, sb, stop_bits, spans = (np.array(c, np.int64) for c in zip(*flat))
    return inflate_pl.decode_symbols_pl(mw, sb, stop_bits, rm, ll, dl, spans,
                                        max_real=max_cmds, window=16, unroll=1,
                                        interpret=True)


def _port_decode(metas, huff, rows, max_cmds):
    st = inflate_cu.stage([metas[i][1] for i in huff], [metas[i][0][1] for i in huff],
                          [metas[i][0][2] for i in huff], rows, "cpu")
    return st, inflate_cu.decode(st["words"], st["tabs"], st["row_ptr"], st["start"],
                                 st["stop"], st["nbits"], st["blocks"], max_cmds)


def _fields(cmds):
    c = cmds.numpy()
    return c >> 26, c & 0x3FF, (c >> 10) & 0xFFFF


def test_decode_plain_matches_reference_kernel(archive):
    payload, buf = archive
    metas, huff, rows, max_cmds = sharded.decode_plan(buf)
    assert len(huff) >= 3 and sum(len(r) for r in rows) > len(huff)
    st, (cmds, ok, ncmds) = _port_decode(metas, huff, rows, max_cmds)
    kinds, values, dists, ok_ref = _reference_decode(metas, huff, rows, max_cmds)
    stops = st["stop"].numpy()
    assert ok.all() and ok_ref.all()
    want = _norm_rows(kinds, values, dists, stops)
    assert _norm_rows(*_fields(cmds), stops) == want
    assert ncmds.tolist() == [len(r) for r in want]
    assert not (cmds.numpy() >> 26 == 3).any()

    # a flipped bit in the first member's end-of-block code: its final
    # row decodes on into the zero padding; both reject that row only
    last = len(rows[0]) - 1
    body = metas[huff[0]][1].copy()
    body[-1] ^= 1 << 7 if body[-1] >> 7 else 1
    bad = list(metas)
    bad[huff[0]] = (metas[huff[0]][0], body, *metas[huff[0]][2:])
    _, (_, ok_b, _) = _port_decode(bad, huff, rows, max_cmds)
    _, _, _, ok_rb = _reference_decode(bad, huff, rows, max_cmds)
    assert ok_b.tolist() == ok_rb.tolist()
    assert (~ok_b).nonzero().flatten().tolist() == [last]


def test_compaction_and_expansion_match_reference(archive):
    payload, buf = archive
    metas, huff, rows, max_cmds = sharded.decode_plan(buf)
    st, (cmds, _, _) = _port_decode(metas, huff, rows, max_cmds)
    kinds = cmds >> 26
    with_nop = kinds.clone()
    with_nop[:, 0] = 3  # a leading NOP slot on every row
    for k in (kinds, with_nop):
        np.testing.assert_array_equal(
            inflate.slot_counts_bits(k, st["stop"]).numpy(),
            np.asarray(ref_inflate.slot_counts_bits(jnp.asarray(k.numpy().astype(np.int8)),
                                                    jnp.asarray(st["stop"].numpy()))))
    ncmds = inflate.slot_counts_bits(kinds, st["stop"])
    total = int(ncmds.sum())
    flat = inflate.compact_commands(cmds, ncmds, 1 << total.bit_length())
    want = ref_inflate.compact_commands(jnp.asarray(cmds.numpy()), jnp.asarray(ncmds.numpy()),
                                        1 << total.bit_length())
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))

    # one member's stream (its rows are consecutive) -> bytes
    lo, hi = st["row_ptr"][:2].tolist()
    first = flat[: int(ncmds[lo:hi].sum())][None]
    mk, mv, md = first >> 26, first & 0x3FF, (first >> 10) & 0xFFFF
    out_len = 1 << 11
    payload_got, len_got = inflate.expand_commands(mk, mv, md, out_len)
    payload_want, len_want = ref_inflate.expand_commands(
        *(jnp.asarray(a.numpy()) for a in (mk.to(torch.int8), mv, md)), out_len)
    np.testing.assert_array_equal(payload_got.numpy(), np.asarray(payload_want))
    np.testing.assert_array_equal(len_got.numpy(), np.asarray(len_want))
    isize = metas[huff[0]][3]
    assert payload_got[0, :isize].numpy().tobytes() == payload[:isize]
