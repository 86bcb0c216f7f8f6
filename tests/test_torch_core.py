"""The port's copies of the reference's JAX-free host code stay equal to it.

``decompress_tpu_torch/core`` (tables, Huffman, bitstream) and the host
half of ``decompress_tpu_torch/de.py`` (constants, the dynamic header,
block costs, ``plan_blocks``, the dynamic-header parser) are copies, so
that the port imports nothing of ``decompress_tpu``.  Every constant that
decides output bytes is compared here, and every copied function runs
beside the reference's on the same seeded inputs.
"""

import zlib

import numpy as np
import pytest

from decompress_tpu import de as ref_de
from decompress_tpu.core import bitstream as ref_bitstream
from decompress_tpu.core import huffman as ref_huffman
from decompress_tpu.core import tables as ref_tables
from decompress_tpu_torch import de
from decompress_tpu_torch.core import bitstream, huffman, tables


def _public_values(mod):
    return {k: v for k, v in vars(mod).items()
            if k.isupper() and isinstance(v, (int, np.ndarray))}


@pytest.mark.parametrize("mod,ref", [(tables, ref_tables), (huffman, ref_huffman)],
                         ids=["tables", "huffman"])
def test_core_constants_match_reference(mod, ref):
    want = _public_values(ref)
    got = _public_values(mod)
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)


def test_de_constants_match_reference():
    for name in ("SEGMENT_SIZE", "_HDR_PAD", "MAX_DEVICE_BATCH", "STRATEGY_LEVELS",
                 "PIPELINE_DEPTH"):
        assert getattr(de, name) == getattr(ref_de, name), name
    assert de.MAX_DEVICE_BATCH == 8
    for name in ("_FIXED_LIT_BITS", "_FIXED_DIST_BITS", "_LEN_EXTRA_OF_SYM",
                 "_DIST_EXTRA_OF_SYM"):
        np.testing.assert_array_equal(getattr(de, name), getattr(ref_de, name))


def _random_hists(rng, b, skew):
    hl = rng.integers(0, 50, (b, tables.NUM_LIT_SYMS)).astype(np.int32)
    hd = rng.integers(0, 20, (b, tables.NUM_DIST_SYMS)).astype(np.int32)
    hl[:, rng.integers(0, 256, 4)] += skew
    hl[0] = 0                       # an empty block (fixed wins)
    hl[1, :256] = 200               # flat literals (stored wins)
    hd[1] = 0
    return hl, hd


@pytest.mark.parametrize("shared", [False, True, "tuple"])
@pytest.mark.parametrize("force", [None, "fixed"])
def test_plan_blocks_matches_reference(shared, force):
    rng = np.random.default_rng(7)
    hl, hd = _random_hists(rng, 6, 5000)
    n_valid = np.array([10, 1000, 5000, 130560, 77, 4096], np.int32)
    finals = np.array([0, 0, 1, 0, 1, 1], bool)
    if shared == "tuple":
        lit = huffman.code_lengths_from_frequencies(hl.astype(np.int64).sum(0) + 1)
        dist = huffman.code_lengths_from_frequencies(hd.astype(np.int64).sum(0) + 1)
        shared = (lit, dist, de.build_dynamic_header(lit, dist))
        ref_shared = (lit, dist, ref_de.build_dynamic_header(lit, dist))
    else:
        ref_shared = shared
    got = de.plan_blocks(hl, hd, n_valid, finals, pad_to=8, force_block=force,
                         shared_tree=shared)
    want = ref_de.plan_blocks(hl, hd, n_valid, finals, pad_to=8, force_block=force,
                              shared_tree=ref_shared)
    assert got[2] == want[2]
    assert {"stored", "fixed", "dynamic"} >= set(got[2])
    for g, w in zip((*got[0], *got[1]), (*want[0], *want[1])):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_header_and_costs_match_reference():
    rng = np.random.default_rng(3)
    for _ in range(5):
        freqs = rng.integers(0, 300, 286) * (rng.random(286) < 0.6)
        lit = huffman.code_lengths_from_frequencies(freqs + (np.arange(286) == 256))
        dist = huffman.code_lengths_from_frequencies(rng.integers(0, 30, 30))
        np.testing.assert_array_equal(lit, ref_huffman.code_lengths_from_frequencies(
            freqs + (np.arange(286) == 256)))
        np.testing.assert_array_equal(huffman.canonical_codes(lit),
                                      ref_huffman.canonical_codes(lit))
        assert huffman.kraft_slack(lit) == ref_huffman.kraft_slack(lit)
        g, w = de.build_dynamic_header(lit, dist), ref_de.build_dynamic_header(lit, dist)
        np.testing.assert_array_equal(g.values, w.values)
        np.testing.assert_array_equal(g.nbits, w.nbits)
        assert g.bit_length == w.bit_length
        assert de.symbol_cost_bits(freqs, freqs[:30], lit, dist) == \
            ref_de.symbol_cost_bits(freqs, freqs[:30], lit, dist)


def test_bitstream_and_stored_match_reference():
    rng = np.random.default_rng(5)
    vals = rng.integers(0, 1 << 16, 300).astype(np.uint32)
    nbits = rng.integers(0, 17, 300).astype(np.int32)
    packed, total = bitstream.pack_bits(vals, nbits, bit_offset=3)
    want_packed, want_total = ref_bitstream.pack_bits(vals, nbits, bit_offset=3)
    np.testing.assert_array_equal(packed, want_packed)
    assert total == want_total
    payload = rng.integers(0, 256, 70_000, dtype=np.uint8)
    w, rw = bitstream.BitWriter(), ref_bitstream.BitWriter()
    for writer, emit in ((w, de._emit_stored), (rw, ref_de._emit_stored)):
        writer.write(5, 3)
        emit(writer, payload, final=True)
    assert w.getvalue() == rw.getvalue()
    r, rr = bitstream.BitReader(de._np_u8(w.getvalue())), ref_bitstream.BitReader(
        ref_de._np_u8(rw.getvalue()))
    assert [r.read(3), r.read(13), r.peek(15)] == [rr.read(3), rr.read(13), rr.peek(15)]


@pytest.mark.parametrize("level", [1, 6, 9])
def test_parse_dynamic_lengths_matches_reference(level):
    x = open(__file__, "rb").read()
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    body = de._np_u8(c.compress(x) + c.flush())
    r, rr = bitstream.BitReader(body), ref_bitstream.BitReader(body)
    assert (r.read(3), rr.read(3)) == (5, 5)  # a final dynamic block
    got, want = de._parse_dynamic_lengths(r), ref_de._parse_dynamic_lengths(rr)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (r.pos, r.nbits) == (rr.pos, rr.nbits)
    bad = body.copy()
    bad[0] = (bad[0] & 7) | (31 << 3)  # HLIT = 288 symbols: invalid
    r = bitstream.BitReader(bad)
    r.read(3)
    with pytest.raises(de.MalformedError, match="invalid dictionary"):
        de._parse_dynamic_lengths(r)
