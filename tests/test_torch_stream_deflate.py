"""The streaming encoders' device half == the reference's, on the CPU.

The port's ``streaming.Deflate``, ``Lz77``, ``QueueDeflate``, the
streaming ``zl.Def`` / ``gz.Def`` on both engines, the ``higher_compress``
loops and ``lz.compress_into`` on the match finder, with ``device="cpu"``
(the plain PyTorch versions of the kernels), against ``decompress_tpu``
(JAX on the CPU, its framing checksums pinned to zlib's by
``tests/ref_host.py``): the same bytes, and for the match finder
(``de.match_commands``, ``match_commands_batch``, and a ``de.Batch``'s
round A and finish, as the encoders run them) the same arrays.  The reference pads every device call to MAX_DEVICE_BATCH
rows; the port pads to the power of two above its rows (one row for a
streaming segment), which these equalities license.  A streamed segment
sees the previous 32 KiB, so ``streaming.Deflate`` also equals the port's
one-shot ``de.deflate`` at the same segment size (levels 1-12).
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
from decompress_tpu import lz as ref_lz
from decompress_tpu import streaming as ref_streaming
from decompress_tpu import zl as ref_zl
from decompress_tpu.ops import lz77 as ref_lz77
from decompress_tpu_torch import de, gz, lz, streaming, zl
from ref_host import ref_host  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

CORPUS = pathlib.Path(__file__).parent / "corpus"
CPU = dict(device="cpu")
META = dict(filename="stream.txt", comment="c", mtime=1234, extra=b"AB\x02\x00hi",
            fhcrc=True, text=True)


def _read(name):
    return (CORPUS / name).read_bytes()


#: 9,000 bytes: 3 segments of 4096 (the last 808) or 2 of 8192
DATA = _read("paper1")[:9000]


def _pushed(enc, data, piece):
    """Push ``data`` in ``piece``-byte calls (None: whole), then finish."""
    piece = piece or max(1, len(data))
    return b"".join(enc.push(data[i:i + piece]) for i in range(0, len(data), piece)) \
        + enc.finish()


@functools.lru_cache(maxsize=None)
def _ref_deflate(level, seg):
    return _pushed(ref_streaming.Deflate(level, segment_size=seg), DATA, 3000)


@functools.lru_cache(maxsize=None)
def _port_one_shot(level, seg):
    return de.deflate(DATA, level, segment_size=seg, **CPU)


@pytest.mark.parametrize("level,seg,piece", [
    (0, 4096, 1), (0, 8192, None), (4, 4096, 3000), (4, 8192, 1), (4, 4096, None),
    (6, 4096, 1), (6, 4096, 3000), (6, 8192, None), (6, 8192, 3000)])
def test_streaming_deflate_matches_reference(level, seg, piece):
    """Pushes of 1 byte, 3,000 bytes and the whole input give the
    reference's stream (its segments are cut by segment_size only).  At
    level 0 each segment is its own stored block, where the one-shot
    stream stores 65,535-byte blocks."""
    got = _pushed(streaming.Deflate(level, segment_size=seg, **CPU), DATA, piece)
    assert got == _ref_deflate(level, seg)
    if level:
        assert got == _port_one_shot(level, seg)
    assert zlib.decompressobj(-15).decompress(got) == DATA


def test_streaming_deflate_empty_and_finished():
    for level in (0, 6):
        enc = streaming.Deflate(level, **CPU)
        want = ref_streaming.Deflate(level)
        assert enc.finish() == want.finish() == de.deflate(b"", level, **CPU)
        assert enc.finish() == b""
        with pytest.raises(ValueError, match="already finished"):
            enc.push(b"x")


def test_match_commands_batch_matches_reference():
    """Ragged chunks in one call, with no history, a short one and more
    than 32 KiB of it, at seg 4096; one chunk alone at the default seg."""
    raw = _read("book1")
    chunks = [raw[50000:54096], raw[60000:64096], raw[70000:71000]]
    hists = [b"", raw[50000 - 10000:50000], raw[70000 - 40000:70000]]
    got = de.match_commands_batch(chunks, hists, 6, seg=4096, **CPU)
    want = ref_de.match_commands_batch(chunks, hists, 6, seg=4096)
    assert len(got) == len(want) == 3
    for g, w, c, h in zip(got, want, chunks, hists):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)
        assert de.reconstruct(list(h) + g.tolist())[len(h):] == c
    one = de.match_commands(chunks[2], hists[2], 4, **CPU)
    np.testing.assert_array_equal(one, ref_de.match_commands(chunks[2], hists[2], 4))
    with pytest.raises(ValueError, match="too many chunks"):
        de.match_commands_batch([b"x"] * 9, [b""] * 9, **CPU)
    with pytest.raises(ValueError, match="chunk larger than segment"):
        de.match_commands_batch([b"x" * 5000], [b""], seg=4096, **CPU)


@pytest.mark.parametrize("level", [1, 4, 6])
def test_analyze2_matches_reference(level):
    raw = np.frombuffer(_read("paper1"), np.uint8)
    rows = de.batch_rows(*de._segments(raw[: 2 * 4096 - 700], 0, 2, 4096), 4096)
    data, n_valid, hist_len = rows.data, rows.n_valid, rows.hist_len
    want = ref_lz77.analyze2(jnp.asarray(data), jnp.asarray(n_valid),
                             jnp.asarray(hist_len), level=level, seg_len=4096)
    got = de.Batch(rows, torch.device("cpu")).start(level).finish().res
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def _lz77_run(mod, level, capacity, pieces, **kw):
    """Lz77 with chunk 4096: every token, the queue's contents at each
    flush and at the end, the frequencies and the running Adler-32."""
    q = mod.Queue(capacity)
    lz77_ = mod.Lz77(q, level, chunk=4096, **kw)
    trace = []
    for piece in pieces + [b""]:
        lz77_.src(piece)
        while (tok := lz77_.compress()) == "flush":
            trace.append(q.as_array().tolist())
            q.junk_exn(len(q))
        trace.append(tok)
    trace.append(q.as_array().tolist())
    return trace, lz77_.literals.tolist(), lz77_.distances.tolist(), lz77_.checksum_value


@pytest.mark.parametrize("level,capacity,piece", [(4, 1 << 14, None), (1, 1 << 13, 3000)])
def test_lz77_matches_reference(ref_host, level, capacity, piece):
    """All at once: one call of 3 ragged chunks; in 3,000-byte pieces
    into a smaller queue: several calls and flushes."""
    data = _read("obj2")[:10000]
    pieces = [data] if piece is None else [data[i:i + piece]
                                           for i in range(0, len(data), piece)]
    got = _lz77_run(streaming, level, capacity, pieces, **CPU)
    want = _lz77_run(ref_streaming, level, capacity, pieces)
    assert got == want
    assert got[3] == zlib.adler32(data)
    cmds = [c for part in got[0] if isinstance(part, list) for c in part]
    assert cmds[-1] == de.CMD_EOB and de.reconstruct(cmds[:-1]) == data


def test_lz77_empty_input():
    q = streaming.Queue(16)
    lz77_ = streaming.Lz77(q, **CPU)
    assert lz77_.compress() == "await"
    lz77_.src(b"")
    assert lz77_.compress() == "end" and lz77_.compress() == "end"
    assert q.to_list() == [("end", None)] and lz77_.checksum_value == 1


def test_queue_deflate_matches_reference(ref_host):
    data = _read("progc")[:20000]
    got = _pushed(streaming.QueueDeflate(6, **CPU), data, 7000)
    assert got == _pushed(ref_streaming.QueueDeflate(6), data, 7000)
    assert zlib.decompressobj(-15).decompress(got) == data
    fixed = _pushed(streaming.QueueDeflate(6, dynamic=False, **CPU), data[:6000], None)
    assert fixed == _pushed(ref_streaming.QueueDeflate(6, dynamic=False), data[:6000], None)
    enc, ref = streaming.QueueDeflate(6, **CPU), ref_streaming.QueueDeflate(6)
    assert enc.finish() == ref.finish()
    assert enc.bits_rem() == ref.bits_rem() and enc.finish() == b""
    with pytest.raises(ValueError, match="already finished"):
        enc.push(b"x")


@pytest.mark.parametrize("engine", ["segment", "queue"])
def test_zlib_gzip_def_match_reference(ref_host, engine):
    data = _read("paper2")[:6000]
    seg = dict(segment_size=8192) if engine == "segment" else {}
    got = _pushed(zl.Def(4, engine=engine, **seg, **CPU), data, 2500)
    assert got == _pushed(ref_zl.Def(4, engine=engine, **seg), data, 2500)
    assert zlib.decompress(got) == data
    got = _pushed(gz.Def(6, engine=engine, **seg, **META, **CPU), data, 2500)
    assert got == _pushed(ref_gz.Def(6, engine=engine, **seg, **META), data, 2500)
    assert gzip.decompress(got) == data
    assert gz.decompress_ex(got)[1] == gz.Metadata(
        filename="stream.txt", comment="c", mtime=1234, os=gz.OS.UNIX,
        extra=b"AB\x02\x00hi", text=True)


def _loop(higher, data, **kw):
    pieces = iter([data[i:i + 2000] for i in range(0, len(data), 2000)] + [b""])
    out = []
    higher(pieces.__next__, out.append, **kw)
    return b"".join(out)


def test_higher_compress_matches_reference(ref_host):
    data = _read("news")[:5000]
    for port, ref, kw in [(streaming, ref_streaming, dict(level=1)),
                          (zl, ref_zl, dict(level=1)),
                          (gz, ref_gz, dict(level=6, segment_size=4096, **META))]:
        got = _loop(port.higher_compress, data, **kw, **CPU)
        assert got == _loop(ref.higher_compress, data, **kw)
    assert gzip.decompress(got) == data
    assert streaming.compress_to_string(data, 1, **CPU) == ref_streaming.compress_to_string(data, 1)


def test_lz_compress_into_on_match_finder_matches_reference():
    data = _read("progp")[:6000]
    q, rq = lz.Queue(1 << 14), ref_lz.Queue(1 << 14)
    lz.compress_into(q, data, **CPU)
    ref_lz.compress_into(rq, data, device=True)
    assert q.as_array().tolist() == rq.as_array().tolist()
    cmds = q.as_array().tolist()
    assert cmds[-1] == de.CMD_EOB and de.reconstruct(cmds[:-1]) == data


def test_unknown_engine_raises():
    for mod in (zl, ref_zl):
        with pytest.raises(ValueError, match="unknown engine 'fast'"):
            mod.Def(6, engine="fast")
    for mod in (gz, ref_gz):
        with pytest.raises(ValueError, match="unknown engine 'fast'"):
            mod.Def(6, engine="fast")


def test_default_device_raises_without_cuda():
    """``device="cuda"`` is the default; without a card every entry point
    raises at once (constructors included): nothing runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    calls = [lambda: streaming.Deflate(6), lambda: streaming.Deflate(0),
             lambda: streaming.Lz77(streaming.Queue()), lambda: streaming.QueueDeflate(),
             lambda: zl.Def(6), lambda: zl.Def(6, engine="queue"), lambda: gz.Def(6),
             lambda: gz.Def(6, engine="queue"), lambda: de.match_commands(b"abc"),
             lambda: de.match_commands_batch([b"abc"], [b""]),
             lambda: lz.compress_into(lz.Queue(), b"abc", device=True),
             lambda: lz.compress_into(lz.Queue(), b"abc", device="cuda"),
             lambda: streaming.compress_to_string(b"abc"),
             lambda: streaming.higher_compress(iter([b"abc", b""]).__next__, print),
             lambda: de.deflate_segment_into(None, b"abc", b"", 6, 4096, True)]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
