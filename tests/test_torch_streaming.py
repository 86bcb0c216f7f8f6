"""The streaming codecs' host half == the reference's, step by step.

The port's copies (``decompress_tpu_torch.streaming``, ``de``, ``lz``)
against ``decompress_tpu``'s on the same inputs, with no device work: the
command packing and its constants, the ``Queue`` ring, the host command
encoders (``reconstruct``, ``encode_commands``, ``encode_blocks``), the
queue-driven ``Def`` entropy encoder through its protocol cases (a 1-byte
dst, the block handshake, flat blocks and a forced switch, ``bits_rem``,
``block_of_frequencies``) with every token and every byte equal, and the
host rolling-hash matcher of ``lz`` (``State``, ``compress_into``).
"""

import pathlib
import zlib

import numpy as np
import pytest

from decompress_tpu import de as ref_de
from decompress_tpu import lz as ref_lz
from decompress_tpu import streaming as ref_streaming
from decompress_tpu_torch import de, lz, streaming

CORPUS = pathlib.Path(__file__).parent / "corpus"
BOTH = [(ref_streaming, ref_de), (streaming, de)]


def _read(name):
    return (CORPUS / name).read_bytes()


def _commands(data: bytes) -> list[int]:
    """The host matcher's commands for ``data`` (no EOB)."""
    q = lz.Queue(1 << 16)
    lz.compress_into(q, data, eob=False)
    return [int(c) for c in q.as_array()]


def test_command_packing_matches_reference():
    assert de._CMD_COPY_FLAG == ref_de._CMD_COPY_FLAG
    assert de.CMD_EOB == ref_de.CMD_EOB
    assert de.io_buffer_size == ref_de.io_buffer_size
    for off, ln in [(1, 3), (32768, 258), (5, 100), (4096, 3), (1000, 17)]:
        c = de.cmd_copy(off, ln)
        assert c == ref_de.cmd_copy(off, ln)
        assert de.cmd_unpack(c) == ref_de.cmd_unpack(c) == ("copy", (off, ln))
        assert de.cmd_is_copy(c) and ref_de.cmd_is_copy(c)
    for b in (0, 65, 255, 256 + 65):
        assert de.cmd_literal(b) == ref_de.cmd_literal(b)
        assert de.cmd_unpack(de.cmd_literal(b)) == ref_de.cmd_unpack(ref_de.cmd_literal(b))
    assert de.cmd_unpack(de.CMD_EOB) == ref_de.cmd_unpack(ref_de.CMD_EOB) == ("end", None)
    for off, ln in [(0, 3), (32769, 3), (1, 2), (1, 259)]:
        with pytest.raises(ValueError) as got:
            de.cmd_copy(off, ln)
        with pytest.raises(ValueError) as want:
            ref_de.cmd_copy(off, ln)
        assert str(got.value) == str(want.value)
    for n, seg in [(0, None), (1, None), (10 ** 6, None), (10 ** 6, 4096), (70000, 1 << 20)]:
        assert de.compress_bound(n, seg) == ref_de.compress_bound(n, seg)


def _queue_trace(mod):
    """The same ring operations on a module's Queue; every observable."""
    q = mod.Queue(8)
    seen = []

    def snap():
        seen.append((len(q), q.is_empty(), q.is_full(), q.available(),
                     q.ends_with_eob(), q.as_array().tolist(), q.to_list()))

    snap()
    q.blit(b"abc")
    snap()
    seen.append(q.peek_exn())
    q.end_with_eob()
    snap()
    q.rem_last_exn()
    q.junk_exn(2)
    q.blit(b"defgh")  # wraps around the ring
    snap()
    seen.append(q.pop_exn())
    q.push_exn(mod.de.cmd_copy(3, 10))
    q.push_array(np.array([1, 2], np.int64))
    snap()
    for op in (lambda: q.push_exn(7), lambda: q.blit(b"x"),
               lambda: q.push_array(np.array([1], np.int64))):
        with pytest.raises(OverflowError) as e:
            op()
        seen.append(str(e.value))
    while not q.is_empty():
        seen.append(q.pop_exn())
    for op in (q.pop_exn, q.peek_exn, q.rem_last_exn, lambda: q.junk_exn(1)):
        with pytest.raises(IndexError) as e:
            op()
        seen.append(str(e.value))
    with pytest.raises(ValueError):
        mod.Queue(12)
    cmds = [("literal", 97), ("literal", "b"), ("copy", (2, 5)), ("end", None)]
    r = mod.Queue.of_list(cmds, capacity=16)
    seen.append((r.capacity, r.as_array().tolist(), r.to_list()))
    return seen


def test_queue_ring_matches_reference():
    assert _queue_trace(streaming) == _queue_trace(ref_streaming)


@pytest.mark.parametrize("name", ["paper1", "obj1"])
def test_host_command_encoders_match_reference(name):
    data = _read(name)[:6000]
    cmds = _commands(data)
    assert any(de.cmd_is_copy(c) for c in cmds)
    assert de.reconstruct(cmds) == ref_de.reconstruct(cmds) == data
    assert de.reconstruct(cmds + [de.CMD_EOB, 65]) == data
    for block in (None, "fixed", "dynamic"):
        for final in (True, False):
            got = de.encode_commands(cmds, block=block, final=final)
            assert got == ref_de.encode_commands(cmds, block=block, final=final)
    got = de.encode_commands(cmds)
    assert zlib.decompressobj(-15).decompress(got) == data
    third = len(cmds) // 3
    blocks = [(cmds[:third], "fixed"), (cmds[third:2 * third], "dynamic"),
              (cmds[2 * third:], None), ([], None)]
    got = de.encode_blocks(blocks)
    assert got == ref_de.encode_blocks(blocks)
    assert zlib.decompressobj(-15).decompress(got) == data
    assert de.encode_blocks(blocks, final=False) == ref_de.encode_blocks(blocks, final=False)
    with pytest.raises(de.MalformedError, match="invalid distance"):
        de.reconstruct([65, de.cmd_copy(2, 3)])
    with pytest.raises(ref_de.MalformedError, match="invalid distance"):
        ref_de.reconstruct([65, ref_de.cmd_copy(2, 3)])


def _drive(mod, q, actions, dst_size=1):
    """Drive a Def protocol byte-at-a-time: every token and the bytes
    taken out at each step."""
    enc = mod.Def(q)
    trace = []
    buf = np.zeros(dst_size, np.uint8)
    enc.dst(buf)
    tok = enc.encode(next(actions))
    while True:
        trace.append(tok)
        if tok == "partial":
            trace.append(bytes(buf[: enc._dst_pos]))
            enc.dst(buf)
            tok = enc.encode("await")
        elif tok == "block":
            tok = enc.encode(next(actions))
        elif tok == "ok":
            trace.append(bytes(buf[: enc._dst_pos]))
            try:
                trace.append(enc.bits_rem())
            except ValueError as e:  # no last block's EOB yet
                trace.append(str(e))
            return trace


def _stream(trace) -> bytes:
    return b"".join(t for t in trace if isinstance(t, bytes))


def _dynamic(mod, text: bytes):
    """Trees from the literal counts of ``text`` (no distances)."""
    lits = np.zeros(287, np.int64)
    for b in text:
        lits[b] += 1
    lits[256] = 1
    return mod.dynamic_of_frequencies(lits, np.zeros(30, np.int64))


@pytest.mark.parametrize("dst_size", [1, 3, 1 << 16])
def test_def_byte_at_a_time_resume(dst_size):
    data = b"resumable encoder " * 40
    traces = []
    for mod, _ in BOTH:
        q = mod.Queue(4096)
        q.blit(data)
        q.end_with_eob()
        dyn = _dynamic(mod, data)
        traces.append(_drive(mod, q, iter([mod.Block("dynamic", True, dyn)]), dst_size))
    assert traces[0] == traces[1]
    d = zlib.decompressobj(-15)
    assert d.decompress(_stream(traces[1])) == data and d.eof


def test_def_block_handshake():
    """A literal outside the current dynamic tree: the encoder writes the
    EOB, returns "block", and the caller switches kinds mid-stream."""
    data = b"aaaaabbbbbZccc"
    traces = []
    for mod, _ in BOTH:
        q = mod.Queue(1024)
        dyn = _dynamic(mod, b"aaaaabbbbbccc")
        assert dyn.lit_lengths[ord("Z")] == 0
        q.blit(data)
        q.end_with_eob()
        actions = iter([mod.Block("dynamic", False, dyn), mod.Block("fixed", True)])
        traces.append(_drive(mod, q, actions, dst_size=3))
    assert traces[0] == traces[1]
    assert traces[1].count("block") == 1
    d = zlib.decompressobj(-15)
    assert d.decompress(_stream(traces[1])) == data and d.eof


def test_def_encodes_host_matcher_commands_across_blocks():
    """Copies through a dynamic block whose trees lack some of them, a
    fixed block up to an EOB command midway, then the last, dynamic block."""
    data = _read("paper1")[:5000]
    cmds = _commands(data)
    half = len(cmds) // 2
    traces = []
    for mod, mde in BOTH:
        q = mod.Queue(1 << 13)
        q.push_array(np.array(cmds[:half] + [mde.CMD_EOB] + cmds[half:], np.int64))
        q.end_with_eob()
        first = _dynamic(mod, data[:200])
        lits = np.zeros(287, np.int64)
        lits[:256] = np.bincount(np.frombuffer(data, np.uint8), minlength=256)
        lits[256:286] = 1
        full = mod.dynamic_of_frequencies(lits, np.ones(30, np.int64))
        actions = iter([mod.Block("dynamic", False, first), mod.Block("fixed", False),
                        mod.Block("dynamic", True, full)] + [mod.Block("fixed", True)] * 8)
        traces.append(_drive(mod, q, actions, dst_size=7))
    assert traces[0] == traces[1]
    assert traces[1].count("block") == 2 and isinstance(traces[1][-1], int)
    d = zlib.decompressobj(-15)
    assert d.decompress(_stream(traces[1])) == data and d.eof


def test_def_flat_and_forced_switch():
    """Flat blocks take LEN from the queue at header time; a forced
    mid-stream switch writes the current block's EOB, then the header."""
    runs = []
    for mod, mde in BOTH:
        seen = []
        q = mod.Queue(1024)
        q.blit(b"raw stored payload")
        q.end_with_eob()
        seen.append(_drive(mod, q, iter([mod.Block("flat", True)]), dst_size=2))
        q = mod.Queue(1024)
        q.blit(b"flat then fixed")
        seen.append(_drive(mod, q, iter([mod.Block("flat", False), mod.Block("fixed", True)]),
                           dst_size=4))
        q = mod.Queue(1024)
        q.blit(b"first half ")
        enc = mod.Def(q)
        buf = np.zeros(1 << 14, np.uint8)
        enc.dst(buf)
        seen.append(enc.encode(mod.Block("fixed", False)))
        q.blit(b"second half")
        q.end_with_eob()
        seen.append(enc.encode(mod.Block("fixed", True)))
        seen.append((bytes(buf[: enc._dst_pos]), enc.bits_rem()))
        with pytest.raises(ValueError) as e:
            enc.encode(mod.Block("fixed", False))
        seen.append(str(e.value))
        q = mod.Queue(16)
        q.push_exn(mde.cmd_copy(1, 3))
        enc = mod.Def(q)
        enc.dst(np.zeros(64, np.uint8))
        with pytest.raises(ValueError) as e:
            enc.encode(mod.Block("flat", True))
        seen.append(str(e.value))
        runs.append(seen)
    assert runs[0] == runs[1]
    d = zlib.decompressobj(-15)
    assert d.decompress(_stream(runs[1][0])) == b"raw stored payload" and d.eof


def test_def_bits_rem_and_protocol_errors():
    runs = []
    for mod, _ in BOTH:
        seen = []
        q = mod.Queue(1024)
        q.blit(b"alignment probe")
        q.end_with_eob()
        enc = mod.Def(q)
        buf = np.zeros(1 << 14, np.uint8)
        enc.dst(buf)
        with pytest.raises(ValueError) as e:
            enc.bits_rem()
        seen.append(str(e.value))
        seen.append(enc.encode(mod.Block("fixed", True)))
        seen.append((bytes(buf[: enc._dst_pos]), enc.bits_rem()))
        for bad in (lambda: enc.encode("bogus"),
                    lambda: enc.dst(np.zeros(4, np.int32)),
                    lambda: enc.dst(np.zeros(4, np.uint8), 3, 2),
                    lambda: mod.Block("stored"), lambda: mod.Block("dynamic")):
            with pytest.raises(ValueError) as e:
                bad()
            seen.append(str(e.value))
        # "flush" before any block opens the default fixed block
        q = mod.Queue(64)
        q.blit(b"zz")
        enc = mod.Def(q)
        enc.dst(np.zeros(64, np.uint8))
        seen.append(enc.encode("flush"))
        seen.append(enc.dst_rem())
        runs.append(seen)
    assert runs[0] == runs[1]
    comp, rem = runs[1][2]
    assert 0 <= rem < 8 and (rem == 0 or comp[-1] >> (8 - rem) == 0)


@pytest.mark.parametrize("counts", [
    {ord("a"): 2}, {ord("a"): 10000, ord("b"): 5000}, {}, {260: 40, 65: 3},
    {b: 50 + b for b in range(256)}])
@pytest.mark.parametrize("last", [False, True])
def test_block_of_frequencies_matches_reference(counts, last):
    lits = np.zeros(287, np.int64)
    for k, v in counts.items():
        lits[k] = v
    lits[256] = 1
    dists = np.zeros(30, np.int64)
    if 260 in counts:
        dists[[0, 4, 12]] = [10, 20, 30]
    got = streaming.block_of_frequencies(last, lits, dists)
    want = ref_streaming.block_of_frequencies(last, lits, dists)
    assert (got.kind, got.last) == (want.kind, want.last)
    if want.kind == "dynamic":
        for attr in ("lit_lengths", "dist_lengths", "lit_codes", "dist_codes"):
            np.testing.assert_array_equal(getattr(got.dynamic, attr),
                                          getattr(want.dynamic, attr))
        np.testing.assert_array_equal(got.dynamic.header.values,
                                      want.dynamic.header.values)


def test_lz_make_window_matches_reference():
    for bits in range(8, 16):
        assert lz.make_window(bits) == ref_lz.make_window(bits)
    for bits in (7, 16):
        with pytest.raises(ValueError) as got:
            lz.make_window(bits)
        with pytest.raises(ValueError) as want:
            ref_lz.make_window(bits)
        assert str(got.value) == str(want.value)


def _lz_run(mod, data: bytes, feed: int, capacity: int):
    """State over ``data`` in ``feed``-byte pieces into a queue of
    ``capacity``: every token, and the commands drained at each flush."""
    q = mod.Queue(capacity)
    st = mod.State(q)
    trace = []
    for i in range(0, len(data), feed):
        st.src(data[i:i + feed])
        while (tok := st.compress()) == "flush":
            trace.append(q.as_array().tolist())
            q.junk_exn(len(q))
        trace.append(tok)
    st.src(b"")
    while (tok := st.compress()) != "end":
        trace.append(tok)
        trace.append(q.as_array().tolist())
        q.junk_exn(len(q))
    trace.append(q.as_array().tolist())
    trace.append(st.compress())
    return trace


@pytest.mark.parametrize("feed,capacity", [(333, 1 << 16), (4096, 256), (1, 64)])
def test_lz_state_matches_reference(feed, capacity):
    rng = np.random.default_rng(7)
    data = _read("paper1")[:3000] + bytes(int(b) for b in rng.integers(0, 3, 1500))
    got = _lz_run(lz, data, feed, capacity)
    assert got == _lz_run(ref_lz, data, feed, capacity)
    cmds = [c for part in got if isinstance(part, list) for c in part]
    assert cmds[-1] == de.CMD_EOB and de.reconstruct(cmds[:-1]) == data
    with pytest.raises(ValueError):
        st = lz.State(lz.Queue(16))
        st.src(b"")
        st.src(b"x")


@pytest.mark.parametrize("name", ["progc", "obj1"])
def test_lz_compress_into_host_matches_reference(name):
    data = _read(name)[:8000]
    for eob in (True, False):
        q, rq = lz.Queue(1 << 14), ref_lz.Queue(1 << 14)
        lz.compress_into(q, data, eob=eob)
        ref_lz.compress_into(rq, data, eob=eob)
        assert q.as_array().tolist() == rq.as_array().tolist()
    cmds = [int(c) for c in q.as_array()]
    assert de.reconstruct(cmds) == data
    assert zlib.decompressobj(-15).decompress(de.encode_commands(cmds)) == data
