"""The port's one-shot host inflate against the reference's.

``decompress_tpu_torch.de.inflate`` / ``inflate_ex`` / ``inflate_into``
run the port's copy of the native state machine (``native/tpuz.cpp``);
``de._inflate_python`` is their plain version.  Each is held to the
reference's ``de`` on the same input (the reference pinned to its
pure-Python decoder, ``tests/ref_host.py``) and to ``zlib``: the payload,
the bytes consumed and, on malformed input, the exception's class and
message.  The inputs: seeded streams from ``zlib.compressobj`` at several
levels and strategies, with small windows and a preset dictionary and
with trailing bytes; the golden and fuzz streams of
``tests/test_fixtures.py``; and malformed streams.
"""

import zlib

import numpy as np
import pytest

from decompress_tpu import de as ref_de
from decompress_tpu_torch import de
from decompress_tpu_torch.core import bitstream
from ref_host import ref_host  # noqa: F401


def _text(n: int, seed: int) -> bytes:
    """Seeded bytes with repeats at every distance up to ~20 KB."""
    rng = np.random.default_rng(seed)
    words = [rng.integers(97, 123, rng.integers(2, 9), np.uint8).tobytes()
             for _ in range(400)]
    out = b" ".join(words[i] for i in rng.integers(0, len(words), n // 4))
    return out[:n]


def _raw(data: bytes, level: int = 6, wbits: int = 15, strategy: int = 0,
         zdict: bytes | None = None) -> bytes:
    args = (level, zlib.DEFLATED, -wbits, 9, strategy) + ((zdict,) if zdict else ())
    c = zlib.compressobj(*args)
    return c.compress(data) + c.flush()


ZDICT = _text(3000, 99)
#: (name, stream, window or None, window_bits, payload)
STREAMS = [
    ("level1", _raw(_text(30_000, 1), 1), None, 15, _text(30_000, 1)),
    ("level6", _raw(_text(30_000, 2)), None, 15, _text(30_000, 2)),
    ("level9", _raw(_text(50_000, 3), 9), None, 15, _text(50_000, 3)),
    ("stored", _raw(_text(70_000, 4), 0), None, 15, _text(70_000, 4)),
    ("fixed", _raw(_text(20_000, 5), 6, strategy=zlib.Z_FIXED), None, 15, _text(20_000, 5)),
    ("huffman_only", _raw(_text(20_000, 6), 6, strategy=zlib.Z_HUFFMAN_ONLY), None, 15,
     _text(20_000, 6)),
    ("rle", _raw(bytes(5000) + _text(5000, 7), 6, strategy=zlib.Z_RLE), None, 15,
     bytes(5000) + _text(5000, 7)),
    ("window9", _raw(_text(20_000, 8), 6, wbits=9), None, 9, _text(20_000, 8)),
    ("zdict", _raw(_text(20_000, 9), 6, zdict=ZDICT), np.frombuffer(ZDICT, np.uint8), 15,
     _text(20_000, 9)),
    ("empty", _raw(b""), None, 15, b""),
    ("random", _raw(np.random.default_rng(10).integers(0, 256, 9000, np.uint8).tobytes()),
     None, 15, np.random.default_rng(10).integers(0, 256, 9000, np.uint8).tobytes()),
]
STREAM_IDS = [s[0] for s in STREAMS]


def _outcome(fn, *args, **kw):
    """fn's result, or the raised exception's class name and message."""
    try:
        return fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 - the exception is the result
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("name,stream,window,wbits,payload", STREAMS, ids=STREAM_IDS)
def test_inflate_ex_matches_reference_and_zlib(ref_host, name, stream, window, wbits,
                                               payload):
    tail = b"TRAILING"
    got = de.inflate_ex(stream + tail, window=window, window_bits=wbits)
    assert got == (payload, len(stream))
    assert got == ref_de.inflate_ex(stream + tail, window=window, window_bits=wbits)
    assert got == de._inflate_python(stream + tail, window=window, window_bits=wbits)
    assert de.inflate(stream, window=window, window_bits=wbits) == payload


@pytest.mark.parametrize("name,stream,window,wbits,payload", STREAMS[:4], ids=STREAM_IDS[:4])
def test_inflate_into_matches_reference(ref_host, name, stream, window, wbits, payload):
    for size in (len(payload), len(payload) + 7, max(len(payload) - 1, 0)):
        got_buf = np.zeros(size, np.uint8)
        want_buf = np.zeros(size, np.uint8)
        got = _outcome(de.inflate_into, stream, got_buf)
        assert got == _outcome(ref_de.inflate_into, stream, want_buf)
        np.testing.assert_array_equal(got_buf, want_buf)
    assert _outcome(de.inflate_into, stream, np.zeros(len(payload), np.uint8)) == \
        (len(stream), len(payload))


def test_small_window_rejects_far_distance(ref_host):
    """A stream written with a 32 KiB window, read with a 2^9 one."""
    stream = _raw(_text(20_000, 11))
    want = ("MalformedError", "invalid distance")
    assert _outcome(de.inflate, stream, window_bits=9) == want
    assert _outcome(ref_de.inflate, stream, window_bits=9) == want
    assert _outcome(de._inflate_python, stream, window_bits=9) == want


#: the valid golden and fuzz streams of tests/test_fixtures.py (the
#: reference's test data), some with bytes past the stream's end
GOLDEN = {
    "fixed_empty": b"\x03\x00",
    "stored": b"\x01\x01\x00\xfe\xff\x00",
    "length_extra": b"\xed\xc0\x01\x01\x00\x00\x00\x40\x20\xff\x57\x1b\x42\x2c\x4f",
    "long_distance_and_extra": (
        b"\xed\xcf\xc1\xb1\x2c\x47\x10\xc4\x30\xfa\x6f\x35\x1d\x01\x82"
        b"\x59\x3d\xfb\xbe\x2e\x2a\xfc\x0f\x0c"),
    "window_end": (
        b"\xed\xc0\x81\x00\x00\x00\x00\x80\xa0\xfd\xa9\x17\xa9\x00\x00"
        + b"\x00" * 30 + b"\x06"),
    "flat_of_string": b"\x01\x00\x00\xff\xff",
    "flat_block": b"\x01\x04\x00\xfb\xff\xde\xad\xbe\xef",
    "fuzz0": (b"{\xdc\n s\x11\x1b\xd3\\\x06\xd3w\xb0`\x8e\xc87\x9coZBo"
              b"\xa3\x88\x11\xf7\x9e\xf7\x0ce\xf1\xeasn_$\xd2\xdf\x11"
              b"\xd5\x8a\x93]\x81M\x89<\xf2\xba7\x15c\xc2\x9c\x87\xc2"
              b"\xa7-wo\x06\xc8\xc6"),
    "fuzz1": b"\x13\xd0nO\xc8\xbdr\x14\xb0",
    "fuzz2": b"\x93\x3a\x55\x47\x12\x80\x51\x56\x3a\x01\x00\x00",
    "fuzz3": b"\x93\x3a\x55\x47\x12\x3a\x51\x36\x0a\x01\x00\x00",
    "fuzz4": b"\x93\x3a\x55\x47\x12\x3a\x51\x56\x0a\x06\x80\x00",
    "fuzz5": (b"\x93\x3a\x55\x01\x01\x01\x01\xe6\x01\x01\x01\x01\x01\x01"
              b"\x01\x01\x01\x01\x01\x01\x01\x00\x00"),
    "fuzz6": b"\x93\x8c\x8c\x8c\x8c\x7b\x8c\x8c\x8c\x01\x00\x00",
    "fuzz7": b"\x93\x3a\x55\x69\x12\x3a\x3f\x10\x08\x01\x00\x00",
    "fuzz13": b"\x9b\x0e\x02\x00",
    "fuzz14": (b"\x0b\xff\x7f\x0c\x0c\x8f\xcd\x0e\x02\x21\x64\x0c\x04\x73"
               b"\xff\x80\x20\x0c\x8f\x1c\x1c\x1c\x1c\x0c\x0c\x0c\x0c\x64"
               b"\x1c\x7f\x0c\x0c\x8f\xcd\x0e\x02\x21\xff\xff\x80"),
    "fuzz15": (b"\x75\x85\xcd\x0e\x02\x21\x0c\x84\x3d\xf3\x14\x3d\xc2\x65"
               b"\x63\xb2\x0f\x64\xf8\x69\xdc\xc6\xc2\x12\x58\x12\xe4\xe9"
               b"\x5d\xa3\x28\x26\xee\xad\xc2\x65\x63\xb2\x0f\x64\xf8\x69"
               b"\xdc\xc6\xc2\x12\x58\x12\xe4\xe9\x5d\x66\xfb\xe8\x57\x57"
               b"\x18\xf3\x5b\xdd\xcb\x73"),
    "fuzz18": (b"\x75\x8f\xcd\x0e\x02\x21\x0c\x84\x3d\xf3\x14\x3d\xfc\x54"
               b"\x63\xb2\x0f\x64\xf8\x69\xdc\xc6\xc2\x12\x58\x12\xe4\xe9"
               b"\x5d\xa3\x28\x26\xee\xad\x33\xcd\xfc\x9d\x1a\x5e\x1e\xcc"
               b"\xe7\xf9\x24\x99\x40\x06\xed\x11\x4c\x56\xfb\xe8\x57\x57"
               b"\x0a\xf3\x5b\xd9\xcb\x60\xd5\xd5"),
}


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_and_fuzz_streams_match_reference(ref_host, name):
    comp = GOLDEN[name]
    d = zlib.decompressobj(-15)
    want = (d.decompress(comp), len(comp) - len(d.unused_data))
    assert d.eof
    assert de.inflate_ex(comp) == want
    assert de._inflate_python(comp) == want
    assert ref_de.inflate_ex(comp) == want


def _dynamic_header_with_bad_precode() -> bytes:
    # BTYPE 2, HLIT/HDIST/HCLEN minimal, all precode lengths 0
    return bytes([0b00000101, 0, 0, 0])


def _fixed_copy_at_start() -> bytes:
    """A fixed block whose first symbol copies 3 bytes from distance 1."""
    lit, dist = de._fixed_codes_cached()
    w = bitstream.BitWriter()
    w.write(1, 1)
    w.write(1, 2)
    w.write(int(lit[257]), 7)
    w.write(int(dist[0]), 5)
    w.write(int(lit[256]), 7)
    return w.getvalue()


#: malformed raw streams: the two fuzz findings of tests/test_fixtures.py,
#: then damaged stored, fixed and dynamic blocks
MALFORMED = {
    "fuzz8": b"\x7a\x37\x6d\x99\x13",
    "fuzz9": (b"\x9b\x01\x95\xfc\x51\xd2\xed\xc8\xce\xc8\xff\x80\x00\x00"
              b"\x7f\xff\x79\x2f\xe9\x51\x88\x7b\xb8\x2f\xef\xa5\x8c\xf8"
              b"\xf1\xb6\xce\xc8\xb8\xc8\xff\x2f\x00\x7f\x88\x7b\xbc"),
    "reserved_block_type": b"\x07\x00",
    "stored_bad_complement": b"\x01\x04\x00\xfa\xff\xde\xad\xbe\xef",
    "stored_truncated": b"\x01\x04\x00\xfb\xff\xde\xad",
    "empty_input": b"",
    "no_final_block": b"\x00\x00\x00\xff\xff",
    "dynamic_bad_precode": _dynamic_header_with_bad_precode(),
    "dynamic_truncated": _raw(_text(5000, 12))[:-40],
    "fixed_distance_past_start": _fixed_copy_at_start(),
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_streams_match_reference(ref_host, name):
    comp = MALFORMED[name]
    want = _outcome(ref_de.inflate, comp)
    assert want[0] == "MalformedError", want
    assert _outcome(de.inflate, comp) == want
    assert _outcome(de._inflate_python, comp)[:2] == want
    with pytest.raises(zlib.error):
        d = zlib.decompressobj(-15)
        d.decompress(comp)
        if not d.eof:
            raise zlib.error("incomplete stream")


@pytest.mark.parametrize("seed", range(6))
def test_native_equals_plain_on_corrupted_streams(seed):
    """Random bit flips in a dynamic stream: the port's native decoder and
    its plain version give the same payload, consumed count or error."""
    rng = np.random.default_rng(seed)
    comp = bytearray(_raw(_text(4000, 20 + seed)))
    for bit in rng.integers(0, 8 * len(comp), 1 + seed):
        comp[bit >> 3] ^= 1 << (bit & 7)
    comp = bytes(comp)
    assert _outcome(de.inflate_ex, comp) == _outcome(de._inflate_python, comp)
