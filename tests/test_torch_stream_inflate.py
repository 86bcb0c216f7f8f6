"""The streaming decoders == the reference's, token for token.

``decompress_tpu_torch.streaming.Inflate``, ``zl.Inf`` and ``gz.Inf`` (on
the host, over the port's native state machine) against
``decompress_tpu``'s on the same inputs: streams from stdlib zlib, from the
port and from the reference; output buffers of 1, 777 and 65,536 bytes;
input fed in 1-byte and 4,096-byte pieces.  Every token, every flushed
piece, ``remaining_input``, the metadata and the error messages must be
equal, through ``clone`` mid-stream, ``reset``, ``reset_keep_window``, a
preset dictionary and a small window.  The reference's decoders run on the
port's ``native.InflateStream`` (its C++ is a byte-for-byte copy,
``tests/test_torch_native.py``), so the reference's own native library is
never built or loaded here; its framing checksums are pinned to zlib's by
``tests/ref_host.py``.
"""

import functools
import gzip
import pathlib
import zlib

import pytest

from decompress_tpu import de as ref_de
from decompress_tpu import gz as ref_gz
from decompress_tpu import native as ref_native
from decompress_tpu import streaming as ref_streaming
from decompress_tpu import zl as ref_zl
from decompress_tpu_torch import de, gz, native, streaming, zl
from ref_host import ref_host  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

CORPUS = pathlib.Path(__file__).parent / "corpus"
DATA = (CORPUS / "paper1").read_bytes()[:12000]
META = dict(filename="f.txt", comment="note", mtime=77, extra=b"XY\x01\x00z", fhcrc=True)


@pytest.fixture
def ref(ref_host, monkeypatch):
    """The reference's decoders on the port's native state machine."""
    monkeypatch.setattr(ref_native, "InflateStream", native.InflateStream)


@functools.lru_cache(maxsize=None)
def _raw(source: str) -> bytes:
    if source == "zlib":
        c = zlib.compressobj(6, zlib.DEFLATED, -15)
        return c.compress(DATA) + c.flush()
    if source == "port":
        return de.deflate(DATA, 6, segment_size=4096, device="cpu")
    return ref_de.deflate(DATA, 6, segment_size=4096)


@functools.lru_cache(maxsize=None)
def _zlib(source: str) -> bytes:
    if source == "zlib":
        return zlib.compress(DATA, 9)
    if source == "port":
        return zl.deflate(DATA, 4, segment_size=4096, device="cpu")
    return ref_zl.deflate(DATA, 4, segment_size=4096)


@functools.lru_cache(maxsize=None)
def _gzip(source: str) -> bytes:
    if source == "zlib":
        return gzip.compress(DATA, mtime=5)
    if source == "port":
        return gz.compress(DATA, 6, segment_size=4096, device="cpu", **META)
    return ref_gz.compress(DATA, 6, segment_size=4096, **META)


def _run(dec, stream: bytes, feed: int, limit: int = 1 << 20):
    """Drive a decoder to its end or error: the tokens, each flushed
    piece, then the error message or the bytes never fed to it."""
    pieces = iter([stream[i:i + feed] for i in range(0, len(stream), feed)])
    trace = []
    for _ in range(limit):
        tok = dec.decode()
        trace.append(tok)
        if tok == "await":
            dec.src(next(pieces, b""))
        elif tok == "flush":
            trace.append(dec.flush())
        elif tok == "end":
            trace.append(dec.flush())
            trace.append(("unfed", b"".join(pieces)))
            return trace
        else:
            trace.append(dec.error)
            return trace
    raise AssertionError("decoder made no progress")


def _payload(trace) -> bytes:
    return b"".join(t for t in trace if isinstance(t, bytes))


@pytest.mark.parametrize("source", ["zlib", "port", "reference"])
@pytest.mark.parametrize("o_size,feed", [(1, 1), (777, 4096), (65536, 1), (1, 4096),
                                         (65536, 4096)])
def test_inflate_matches_reference(ref, source, o_size, feed):
    stream = _raw(source) + b"TRAILING"
    got = streaming.Inflate(o_size)
    want = ref_streaming.Inflate(o_size)
    trace = _run(got, stream, feed)
    assert trace == _run(want, stream, feed)
    assert _payload(trace) == DATA
    assert got.remaining_input() == want.remaining_input()
    assert got.remaining_input() + trace[-1][1] == b"TRAILING"
    assert (got.total_out, got.cursor) == (want.total_out, want.cursor) == (len(DATA),) * 2
    assert got.decode() == want.decode() == "end"


@pytest.mark.parametrize("source", ["zlib", "port", "reference"])
@pytest.mark.parametrize("o_size,feed", [(1, 1), (777, 4096), (65536, 1)])
def test_zlib_inf_matches_reference(ref, source, o_size, feed):
    stream = _zlib(source)
    trace = _run(zl.Inf(o_size), stream, feed)
    assert trace == _run(ref_zl.Inf(o_size), stream, feed)
    assert _payload(trace) == DATA


@pytest.mark.parametrize("source", ["zlib", "port", "reference"])
@pytest.mark.parametrize("o_size,feed", [(1, 1), (777, 4096), (65536, 1)])
def test_gzip_inf_matches_reference(ref, source, o_size, feed):
    """Two members: the second decoded after ``reset`` from the first's
    ``remaining_input``; the metadata accessors of each."""
    stream = _gzip(source) + gzip.compress(b"second member", mtime=9)
    runs = []
    for mod in (gz, ref_gz):
        dec = mod.Inf(o_size)
        trace = _run(dec, stream, feed)
        seen = [trace, dec.remaining_input(), dec.filename(), dec.comment(), dec.mtime(),
                int(dec.os()), dec.extra(b"XY"), dec.extra(b"QQ")]
        dec.reset()
        seen.append(_run(dec, trace[-1][1], feed))
        seen.append((dec.filename(), dec.mtime(), dec.remaining_input()))
        runs.append(seen)
    assert runs[0] == runs[1]
    assert _payload(runs[0][0]) == DATA and _payload(runs[0][-2]) == b"second member"
    if source != "zlib":
        assert runs[0][2:8] == ["f.txt", "note", 77, 3, b"z", None]


@pytest.mark.parametrize("cls", ["Inflate", "zl", "gz"])
def test_clone_mid_stream_matches_reference(ref, cls):
    """A clone taken mid-stream resumes on its own; the original too."""
    make = {"Inflate": (lambda m: m.Inflate(1000), _raw("port")),
            "zl": (lambda m: m.Inf(1000), _zlib("port")),
            "gz": (lambda m: m.Inf(1000), _gzip("port"))}[cls]
    build, stream = make
    runs = []
    for mod in ((streaming, zl, gz), (ref_streaming, ref_zl, ref_gz)):
        m = {"Inflate": mod[0], "zl": mod[1], "gz": mod[2]}[cls]
        dec = build(m)
        head = []
        dec.src(stream[:3000])
        while (tok := dec.decode()) == "flush":
            head.append(dec.flush())
        head.append(tok)
        twin = dec.clone()
        rest = _run(dec, stream[3000:], 512)
        twin_rest = _run(twin, stream[3000:], 4096)
        runs.append((head, rest, twin_rest))
    assert runs[0] == runs[1]
    head, rest, twin_rest = runs[0]
    assert _payload(head + rest) == _payload(head + twin_rest) == DATA


def test_inflate_reset_keep_window_and_cursor(ref):
    """reset reuses a decoder; reset_keep_window lets a second raw stream
    copy from the first's output; unsafe_set_cursor moves the ring."""
    base = DATA[:5000]
    c = zlib.compressobj(6, zlib.DEFLATED, -15, zdict=base)
    delta_stream = c.compress(DATA[5000:9000]) + c.flush()
    runs = []
    for mod in (streaming, ref_streaming):
        dec = mod.Inflate(4096)
        seen = [_run(dec, _raw("zlib"), 4096)]
        dec.reset()
        seen.append(_run(dec, _raw("port"), 1000))
        dec.reset()
        seen.append(_run(dec, zlib.compress(base)[2:-4], 4096))
        dec.reset_keep_window()
        seen.append(_run(dec, delta_stream, 4096))
        seen.append((dec.cursor, dec.total_out))
        dec.reset()
        dec.unsafe_set_cursor(123)
        seen.append(dec.cursor)
        runs.append(seen)
    assert runs[0] == runs[1]
    assert _payload(runs[0][3]) == DATA[5000:9000]


def test_preset_dictionary_and_small_window(ref):
    zdict = DATA[6000:9000]
    c = zlib.compressobj(6, zlib.DEFLATED, 15, zdict=zdict)
    fdict = c.compress(DATA[9000:]) + c.flush()
    c = zlib.compressobj(6, zlib.DEFLATED, -15, zdict=zdict)
    raw_dict = c.compress(DATA[9000:]) + c.flush()
    c = zlib.compressobj(9, zlib.DEFLATED, 9)
    small = c.compress(DATA) + c.flush()
    cases = [("zl", dict(zdict=zdict), fdict), ("zl", {}, fdict),
             ("zl", dict(zdict=b"other"), fdict), ("zl", {}, small),
             ("Inflate", dict(window=zdict), raw_dict),
             ("Inflate", dict(window_bits=9), small[2:-4]),
             ("Inflate", dict(window_bits=9), _raw("zlib"))]
    for kind, kw, stream in cases:
        traces = []
        for inflate_cls, inf_cls in ((streaming.Inflate, zl.Inf),
                                     (ref_streaming.Inflate, ref_zl.Inf)):
            dec = inf_cls(1000, **kw) if kind == "zl" else inflate_cls(1000, **kw)
            traces.append(_run(dec, stream, 700))
        assert traces[0] == traces[1], (kind, kw)
    assert _payload(_run(zl.Inf(zdict=zdict), fdict, 100)) == DATA[9000:]
    assert _run(zl.Inf(), fdict, 100)[-1] == "unsupported preset dictionary"
    assert _run(streaming.Inflate(window_bits=9), _raw("zlib"), 100)[-1] == "invalid distance"


def _flip(stream: bytes, pos: int, mask: int) -> bytes:
    b = bytearray(stream)
    b[pos] ^= mask
    return bytes(b)


def _malformed():
    """(decoder kind, stream, o_size) of malformed inputs."""
    raw, zs, gs = _raw("zlib"), _zlib("port"), _gzip("port")
    stored = b"\x01\x05\x00\x00\x00abcde"
    return [
        ("Inflate", b"\x07", 100),                              # reserved block type
        ("Inflate", _flip(stored, 3, 1), 100),                  # bad LEN complement
        ("Inflate", raw[: len(raw) // 2], 100),                 # truncated
        ("Inflate", b"\x05\xe0\xff\xff", 100),                  # bad dynamic header
        ("Inflate", b"", 1),
        ("zl", _flip(zs, 1, 1), 777), ("zl", b"\x79\x9c" + zs[2:], 777),
        ("zl", b"\x88\x98" + zs[2:], 777), ("zl", _flip(zs, len(zs) - 1, 1), 777),
        ("zl", zs[:-2], 777), ("zl", zs[:1], 777), ("zl", b"", 1),
        ("gz", b"\x1f\x8c" + gs[2:], 777), ("gz", gs[:2] + b"\x07" + gs[3:], 777),
        ("gz", gs[:3] + b"\xe8" + gs[4:], 777), ("gz", _flip(gs, 12, 1), 777),
        ("gz", _flip(gs, len(gs) - 6, 1), 777), ("gz", _flip(gs, len(gs) - 2, 1), 777),
        ("gz", gs[:-3], 777), ("gz", gs[:8], 777), ("gz", gs[:30], 777),
        ("gz", _flip(gs, 40, 0x40), 777),
    ]


@pytest.mark.parametrize("feed", [1, 4096])
def test_malformed_messages_match_reference(ref, feed):
    cls = {"Inflate": (streaming.Inflate, ref_streaming.Inflate),
           "zl": (zl.Inf, ref_zl.Inf), "gz": (gz.Inf, ref_gz.Inf)}
    errors = set()
    for kind, stream, o_size in _malformed():
        port_cls, ref_cls = cls[kind]
        got, want = _run(port_cls(o_size), stream, feed), _run(ref_cls(o_size), stream, feed)
        assert got == want, (kind, stream[:16])
        assert got[-2] == "malformed", (kind, stream[:16])
        errors.add(got[-1])
    assert {"invalid kind of block", "invalid complement of length",
            "unexpected end of input", "invalid header checksum", "invalid kind of flow",
            "invalid window", "invalid checksum", "invalid header", "invalid flg",
            "invalid header crc", "invalid size"} <= errors


def test_higher_uncompress_matches_reference(ref):
    def loop(fn, stream, **kw):
        pieces = iter([stream[i:i + 999] for i in range(0, len(stream), 999)])
        out = []
        res = fn(lambda: next(pieces, b""), out.append, **kw)
        return b"".join(out), res

    for port, refm, stream in [(streaming, ref_streaming, _raw("reference")),
                               (zl, ref_zl, _zlib("reference")),
                               (gz, ref_gz, _gzip("reference"))]:
        got = loop(port.higher_uncompress, stream, o_size=4096)
        want = loop(refm.higher_uncompress, stream, o_size=4096)
        assert got[0] == want[0] == DATA
        assert str(got[1]) == str(want[1])
        bad = stream[:-5]
        with pytest.raises(de.MalformedError) as e_got:
            loop(port.higher_uncompress, bad)
        with pytest.raises(ref_de.MalformedError) as e_want:
            loop(refm.higher_uncompress, bad)
        assert str(e_got.value) == str(e_want.value)
        assert type(e_got.value).__name__ == type(e_want.value).__name__
    assert streaming.uncompress_of_string(_raw("port")) == DATA
