"""Streaming (non-blocking) codecs: the resumable half of the library.

Counterpart of ``decompress_tpu/streaming.py``, copied with its control
flow kept exactly (which chunks share a device call, where a block is cut
and which frequencies choose its trees all decide the bytes).  Every codec
is a resumable machine driven by ``decode``/``encode``/``compress``
returning control tokens, with the caller owning the buffers:

* :class:`Queue` -- the command ring between match finding and entropy
  coding, with ``de``'s int packing.
* :class:`Inflate` -- the streaming raw-DEFLATE decoder (tokens
  ``"await" | "flush" | "end" | "malformed"``), on the host, over the
  native resumable state machine (``native.InflateStream``).
* :class:`Deflate` -- the streaming raw-DEFLATE encoder: buffers input into
  segments and encodes each behind the previous 32 KiB on the card
  (``de.deflate_segment_into``); its stream is the one-shot ``de.deflate``'s.
* :class:`Lz77` -- the streaming match finder (``de.match_commands_batch``
  on the card) filling a :class:`Queue`; :class:`Def` -- the queue-driven
  host entropy encoder; :class:`QueueDeflate` -- the two joined.

``device`` is where the match finding runs: ``"cuda"`` (the default) runs
the CUDA kernels and raises from the constructor without a card, ``"cpu"``
their plain PyTorch versions.  The zlib and gzip streaming classes are in
``zl.py`` and ``gz.py``.

Line citations such as ``de.ml:2194`` and ``lz.ml:308``, and "the
reference" beside them, name the OCaml decompress library whose API the
JAX package (and so this copy) follows.
"""

from __future__ import annotations

import copy

import numpy as np

from . import de, native
from .core import bitstream, huffman, tables

TOKEN_AWAIT = "await"
TOKEN_FLUSH = "flush"
TOKEN_END = "end"
TOKEN_MALFORMED = "malformed"
TOKEN_OK = "ok"
TOKEN_PARTIAL = "partial"
TOKEN_BLOCK = "block"


class Queue:
    """Shared command queue (De.Queue parity, de.ml:2194–2328).

    Commands are packed ints: literal = byte, copy = ((len-3)<<16)
    | (off-1) | 0x2000000, EOB = 256 (de.ml:2245–2252).
    """

    def __init__(self, capacity: int = 4096) -> None:
        if capacity & (capacity - 1):
            raise ValueError("capacity must be a power of two")
        self.capacity = capacity
        # ring buffer (the reference uses a power-of-two int bigarray
        # ring, de.ml:2194–2209): O(1) push/pop/junk, O(n) bulk ops are
        # vectorized numpy slices
        self._ring = np.zeros(capacity, dtype=np.int64)
        self._head = 0  # pop side
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def is_empty(self) -> bool:
        return self._len == 0

    def is_full(self) -> bool:
        return self._len >= self.capacity

    def available(self) -> int:
        return self.capacity - self._len

    def push_exn(self, cmd: int) -> None:
        if self.is_full():
            raise OverflowError("queue is full")
        self._ring[(self._head + self._len) & (self.capacity - 1)] = cmd
        self._len += 1

    def pop_exn(self) -> int:
        if self._len == 0:
            raise IndexError("queue is empty")
        cmd = int(self._ring[self._head])
        self._head = (self._head + 1) & (self.capacity - 1)
        self._len -= 1
        return cmd

    def peek_exn(self) -> int:
        if self._len == 0:
            raise IndexError("queue is empty")
        return int(self._ring[self._head])

    def junk_exn(self, n: int) -> None:
        if self._len < n:
            raise IndexError("queue underflow")
        self._head = (self._head + n) & (self.capacity - 1)
        self._len -= n

    def blit(self, data: bytes) -> None:
        """Bulk literal insert (de.ml:2268–2284)."""
        if self.available() < len(data):
            raise OverflowError("queue is full")
        self.push_array(np.frombuffer(bytes(data), np.uint8).astype(np.int64))

    def push_array(self, cmds: np.ndarray) -> None:
        """Bulk command insert (vectorized; the Lz77 hot path)."""
        n = int(cmds.size)
        if self.available() < n:
            raise OverflowError("queue is full")
        cap = self.capacity
        start = (self._head + self._len) & (cap - 1)
        first = min(n, cap - start)
        self._ring[start : start + first] = cmds[:first]
        if n > first:
            self._ring[: n - first] = cmds[first:]
        self._len += n

    def as_array(self) -> np.ndarray:
        """Snapshot of queued commands, oldest first (no dequeue)."""
        cap = self.capacity
        first = min(self._len, cap - self._head)
        return np.concatenate(
            [self._ring[self._head : self._head + first],
             self._ring[: self._len - first]]
        )

    def end_with_eob(self) -> None:
        self.push_exn(de.CMD_EOB)

    def ends_with_eob(self) -> bool:
        """True when the most recently pushed command is EOB (the
        reference `Queue.end_with_eob` predicate, de.ml:2219–2222)."""
        if self._len == 0:
            return False
        last = (self._head + self._len - 1) & (self.capacity - 1)
        return int(self._ring[last]) == de.CMD_EOB

    def rem_last_exn(self) -> None:
        """Drop the most recently pushed command (reference
        `Queue.rem_exn q 1` before a Flat header, de.ml:2674)."""
        if self._len == 0:
            raise IndexError("queue is empty")
        self._len -= 1

    def to_list(self) -> list:
        return [de.cmd_unpack(int(c)) for c in self.as_array()]

    @classmethod
    def of_list(cls, cmds: list, capacity: int = 4096) -> "Queue":
        q = cls(capacity)
        for kind, arg in cmds:
            if kind == "literal":
                q.push_exn(de.cmd_literal(arg if isinstance(arg, int) else ord(arg)))
            elif kind == "copy":
                q.push_exn(de.cmd_copy(*arg))
            elif kind == "end":
                q.push_exn(de.CMD_EOB)
        return q


class Inflate:
    """Streaming raw-DEFLATE decoder with Await/Flush tokens.

    Usage mirrors `De.Inf` (de.mli:82–174)::

        inf = Inflate(o_size=65536)
        inf.src(chunk)            # provide input ('' marks end of input)
        while (tok := inf.decode()) != "end":
            if tok == "await":  inf.src(read_more())
            elif tok == "flush": out.write(inf.flush())
            else: raise ...(inf.error)
        out.write(inf.flush())
    """

    def __init__(self, o_size: int = de.io_buffer_size, window: bytes | None = None,
                 window_bits: int = 15):
        self._stream = native.InflateStream()
        if window_bits != 15:
            # decode-side window restriction (zl.ml:247-280 negotiates
            # the window from CINFO; too-far references are malformed)
            self._stream.set_window_bits(window_bits)
        if window:
            self._stream.set_dictionary(bytes(window))
        self.o_size = o_size
        self._pending_in = b""
        self._out = b""
        self._eoi = False
        self._done = False
        self.error: str | None = None
        self._given_back = b""

    def src(self, data) -> None:
        data = bytes(data)
        if not data:
            self._eoi = True
        self._pending_in += data

    def src_rem(self) -> int:
        return len(self._pending_in)

    def dst_rem(self) -> int:
        return self.o_size - len(self._out)

    def decode(self) -> str:
        if self.error:
            return TOKEN_MALFORMED
        while True:
            if self._done:
                return TOKEN_END
            cap = self.o_size - len(self._out)
            if cap == 0:
                return TOKEN_FLUSH
            status, consumed, produced = self._stream.run(self._pending_in, cap)
            self._pending_in = self._pending_in[consumed:]
            self._out += produced
            if status == self._stream.END:
                self._done = True
                # bytes past the stream end: any whole bytes the state
                # machine buffered from earlier feeds come first
                self._given_back = self._stream.takeback() + self._pending_in
                return TOKEN_END
            if status == self._stream.MALFORMED:
                self.error = self._stream.error
                return TOKEN_MALFORMED
            if status == self._stream.FLUSH:
                return TOKEN_FLUSH
            # AWAIT
            if self._pending_in:
                continue
            if self._eoi:
                self.error = "unexpected end of input"
                return TOKEN_MALFORMED
            return TOKEN_AWAIT

    def flush(self) -> bytes:
        out, self._out = self._out, b""
        return out

    def remaining_input(self) -> bytes:
        """Unconsumed bytes after END (whole-byte give-back,
        de.ml:1459–1466)."""
        return self._given_back

    def clone(self) -> "Inflate":
        """Snapshot this decoder mid-stream (reference immutable-style
        decoders, zl.ml:146–164, exercised by test.ml:1450–1496): the
        returned copy resumes independently — feeding one never affects
        the other."""
        c = copy.copy(self)
        c._stream = self._stream.clone()
        return c

    def reset(self) -> None:
        """Reuse this decoder for a new stream (reference `reset`,
        de.ml:1512–1532: allocations are kept)."""
        self._stream.reset()
        self._pending_in = b""
        self._out = b""
        self._eoi = False
        self._done = False
        self.error = None
        self._given_back = b""

    def unsafe_set_cursor(self, pos: int) -> None:
        """Position the window ring cursor directly (reference
        `unsafe_set_cursor`, de.ml:1826 / de.mli:669): back-references
        of subsequently decoded streams resolve as if ``pos`` bytes had
        been output.  Unsafe exactly like the reference's — no
        validation, the caller owns window consistency."""
        self._stream.unsafe_set_cursor(pos)

    @property
    def cursor(self) -> int:
        """Current window ring cursor (== total bytes output unless
        moved by :meth:`unsafe_set_cursor`)."""
        return self._stream.cursor

    def reset_keep_window(self) -> None:
        """Reset for a NEW raw stream keeping window bytes + cursor —
        the git-delta flow: decode the base object, reset_keep_window,
        decode a delta whose far distances reach into the base (no
        dictionary copy, cf. de.ml:1826's intended use)."""
        self._stream.reset_keep_window()
        self._pending_in = b""
        self._out = b""
        self._eoi = False
        self._done = False
        self.error = None
        self._given_back = b""

    @property
    def total_out(self) -> int:
        return self._stream.total_out


class Deflate:
    """Streaming raw-DEFLATE encoder (De.Lz77 + De.Def pair).

    ``push`` accepts input and returns any compressed bytes ready;
    ``finish`` emits the final block.  Window semantics match the
    reference's sliding window: each segment sees the previous 32 KiB.
    """

    def __init__(self, level: int = 6, segment_size: int | None = None, *,
                 device="cuda"):
        self.device = de._resolve_device(device)
        self.level = level
        self.segment = segment_size or de.SEGMENT_SIZE
        self._buf = bytearray()
        self._hist = b""
        self._w = bitstream.BitWriter()
        self._finished = False

    def push(self, data) -> bytes:
        if self._finished:
            raise ValueError("stream already finished")
        self._buf += bytes(data)
        out = b""
        # emit all full segments except we must keep at least one byte so
        # the final block (BFINAL) can close the stream at finish()
        while len(self._buf) > self.segment:
            chunk = bytes(self._buf[: self.segment])
            del self._buf[: self.segment]
            self._encode_segment(chunk, final=False)
            out += self._w.take_bytes()
        return out

    def finish(self) -> bytes:
        if self._finished:
            return b""
        self._finished = True
        if self._buf:
            self._encode_segment(bytes(self._buf), final=True)
            self._buf.clear()
        else:
            # empty final block: fixed tree, lone EOB
            codes = huffman.canonical_codes(tables.FIXED_LIT_LENGTHS)
            self._w.write(1, 1)
            self._w.write(1, 2)
            self._w.write(int(codes[tables.EOB]), int(tables.FIXED_LIT_LENGTHS[tables.EOB]))
        return self._w.getvalue()

    def _encode_segment(self, chunk: bytes, final: bool) -> None:
        if self.level == 0:
            de._emit_stored(self._w, np.frombuffer(chunk, np.uint8), final)
        else:
            de.deflate_segment_into(
                self._w, chunk, self._hist, self.level, self.segment, final,
                device=self.device)
        self._hist = (self._hist + chunk)[-32768:]


def higher_compress(refill, flush, level: int = 6, *, device="cuda") -> None:
    """camlzip-style raw-DEFLATE compress loop: ``refill()`` yields input
    chunks (b'' = EOF), ``flush(bytes)`` consumes output."""
    enc = Deflate(level, device=device)
    while True:
        chunk = refill()
        if not chunk:
            break
        out = enc.push(chunk)
        if out:
            flush(out)
    flush(enc.finish())


def higher_uncompress(refill, flush, o_size: int = de.io_buffer_size) -> None:
    """camlzip-style raw-DEFLATE uncompress loop, on the host."""
    dec = Inflate(o_size)
    while True:
        tok = dec.decode()
        if tok == TOKEN_AWAIT:
            dec.src(refill())
        elif tok == TOKEN_FLUSH:
            flush(dec.flush())
        elif tok == TOKEN_END:
            flush(dec.flush())
            return
        else:
            raise de.MalformedError(dec.error or "malformed")


def compress_to_string(data, level: int = 6, *, device="cuda") -> bytes:
    """One-shot raw DEFLATE (``de.deflate``)."""
    return de.deflate(data, level, device=device)


def uncompress_of_string(data) -> bytes:
    """One-shot raw-DEFLATE decode on the host (``de.inflate``)."""
    return de.inflate(data)


class Lz77:
    """Streaming match finder emitting commands into a :class:`Queue`
    (`De.Lz77` parity, de.ml:4013–4515).

    ``compress`` returns ``"flush"`` when the queue is too full to hold
    the next chunk's commands, ``"await"`` when out of input, ``"end"``
    after end-of-input is signalled.  The literals/distances frequency
    arrays accumulate like the reference's (de.ml:2330–2351).
    """

    def __init__(self, q: Queue, level: int = 6, chunk: int = 16384, *,
                 device="cuda"):
        self.device = de._resolve_device(device)
        self.q = q
        self.level = level
        self.chunk = chunk
        self._buf = bytearray()
        self._hist = b""
        self._eoi = False
        self._ended = False
        self.literals = np.zeros(286 + 1, dtype=np.int64)
        self.literals[256] = 1  # EOB preset (de.ml:2333–2336)
        self.distances = np.zeros(30, dtype=np.int64)
        self.checksum_value = 1  # running Adler-32 of consumed input

    def src(self, data) -> None:
        data = bytes(data)
        if not data:
            self._eoi = True
        self._buf += data

    def compress(self) -> str:
        while True:
            if self._ended:
                return TOKEN_END
            avail = len(self._buf)
            take_total = avail if self._eoi else (avail // self.chunk) * self.chunk
            if take_total == 0:
                if not self._eoi:
                    return TOKEN_AWAIT
                if self.q.available() < 1:
                    return TOKEN_FLUSH
                self.q.end_with_eob()
                self._ended = True
                return TOKEN_END
            room = self.q.available()
            if room < min(take_total, self.chunk):
                # conservative pre-check (commands <= bytes) so a full
                # queue never wastes a device analysis
                return TOKEN_FLUSH
            # several chunks share one device call, as many as the queue
            # has room for (at most MAX_DEVICE_BATCH; one at the default
            # capacity of QueueDeflate, as in the reference)
            nchunks = min(
                (take_total + self.chunk - 1) // self.chunk,
                de.MAX_DEVICE_BATCH,
                max(1, room // self.chunk),
            )
            chunks, hists = [], []
            off = 0
            hist = self._hist
            for _ in range(nchunks):
                c = bytes(self._buf[off : min(off + self.chunk, take_total)])
                if not c:
                    break
                chunks.append(c)
                hists.append(hist)
                hist = (hist + c)[-32768:]
                off += len(c)
            cmd_rows = de.match_commands_batch(chunks, hists, self.level,
                                               seg=self.chunk, device=self.device)
            cmds = (np.concatenate(cmd_rows) if cmd_rows
                    else np.zeros(0, np.int64))
            if self.q.available() < cmds.size:
                return TOKEN_FLUSH
            self.q.push_array(cmds)
            # vectorized frequency accumulation (de.ml:2338–2351)
            is_copy = (cmds & de._CMD_COPY_FLAG) != 0
            lits = cmds[~is_copy]
            if lits.size:
                self.literals[:256] += np.bincount(lits, minlength=256)[:256]
            cp = cmds[is_copy]
            if cp.size:
                lsyms = 257 + tables.length_to_code(((cp >> 16) & 0x1FF) + 3)
                dsyms = tables.dist_to_code((cp & 0xFFFF) + 1)
                self.literals += np.bincount(
                    lsyms, minlength=self.literals.size)[: self.literals.size]
                self.distances += np.bincount(
                    dsyms, minlength=self.distances.size)[: self.distances.size]
            consumed = off
            self.checksum_value = native.adler32(bytes(self._buf[:consumed]),
                                                 self.checksum_value)
            del self._buf[:consumed]
            self._hist = hist


# ---------------------------------------------------------------------------
# Streaming entropy encoder (De.Def parity, de.ml:2354–3036).
#
# The protocol (de.mli:300–445): a queue-driven resumable encoder over a
# caller-owned dst.  ``encode`` takes an action — "await" | "flush" |
# a :class:`Block` — and returns "ok" (ready / queue drained),
# "partial" (dst full: provide a new buffer via ``dst`` and encode
# "await"), or "block" (the next command is not encodable with the
# current block's trees, or a non-last block just ended: respond with a
# new :class:`Block`).  End of flow = a block with ``last=True`` plus
# ``Queue.eob``; ``bits_rem`` is then the padding bit count of the
# final byte (de.ml:3012–3015), used by zl/gz for byte alignment.
# ---------------------------------------------------------------------------


class Dynamic:
    """A dynamic-block Huffman pair built from frequencies
    (`Def.dynamic_of_frequencies`, de.ml:2387–2407).  Encodes the
    *subset* of symbols whose frequency was nonzero."""

    def __init__(self, literals: np.ndarray, distances: np.ndarray):
        lit_freq = np.zeros(286, dtype=np.int64)
        lit_freq[: min(literals.size, 286)] = literals[:286]
        lit_freq[256] = max(1, int(lit_freq[256]))  # EOB always encodable
        dist_freq = np.zeros(30, dtype=np.int64)
        dist_freq[: min(distances.size, 30)] = distances[:30]
        self.lit_lengths = huffman.code_lengths_from_frequencies(lit_freq)
        self.dist_lengths = huffman.code_lengths_from_frequencies(dist_freq)
        self.lit_codes = huffman.canonical_codes(self.lit_lengths)
        self.dist_codes = huffman.canonical_codes(self.dist_lengths)
        self.header = de.build_dynamic_header(self.lit_lengths, self.dist_lengths)


class Block:
    """A DEFLATE block request: kind "flat" | "fixed" | "dynamic"
    (`Def.block`, de.mli:323–325)."""

    def __init__(self, kind: str, last: bool = False,
                 dynamic: "Dynamic | None" = None):
        if kind not in ("flat", "fixed", "dynamic"):
            raise ValueError(f"unknown block kind {kind!r}")
        if kind == "dynamic" and dynamic is None:
            raise ValueError("dynamic block requires trees")
        self.kind = kind
        self.last = last
        self.dynamic = dynamic


def dynamic_of_frequencies(literals: np.ndarray, distances: np.ndarray) -> Dynamic:
    """`Def.dynamic_of_frequencies` parity (de.ml:2387–2407)."""
    return Dynamic(np.asarray(literals), np.asarray(distances))


def block_of_frequencies(last: bool, literals: np.ndarray,
                         distances: np.ndarray) -> Block:
    """Pick fixed vs dynamic by exact bit cost
    (`Def.block_of_frequencies`, de.ml:2415–2449)."""
    dyn = dynamic_of_frequencies(literals, distances)
    hl = np.zeros(286, np.int64)
    hl[: min(np.asarray(literals).size, 286)] = np.asarray(literals)[:286]
    hd = np.zeros(30, np.int64)
    hd[: min(np.asarray(distances).size, 30)] = np.asarray(distances)[:30]
    cost_dyn = dyn.header.bit_length + de.symbol_cost_bits(
        hl, hd, dyn.lit_lengths.astype(np.int64), dyn.dist_lengths.astype(np.int64))
    cost_fix = de.symbol_cost_bits(hl, hd, de._FIXED_LIT_BITS, de._FIXED_DIST_BITS)
    if cost_fix <= cost_dyn:
        return Block("fixed", last)
    return Block("dynamic", last, dynamic=dyn)


class Def:
    """Queue-driven streaming DEFLATE entropy encoder (`De.Def`,
    de.ml:2354–3036): caller-owned dst, "ok"/"partial"/"block" tokens,
    mid-stream block switching, ``bits_rem`` end alignment.

    The command drain is vectorized (the whole encodable queue prefix
    is code-mapped and bit-packed with numpy in one pass), so this path
    sustains tens of MB/s on host while keeping the reference's exact
    resumability: with a 1-byte dst it still makes byte-at-a-time
    progress.
    """

    def __init__(self, q: Queue):
        self.q = q
        self._w = bitstream.BitWriter()
        self._pending = b""       # packed bytes not yet copied to dst
        self._dst: np.ndarray | None = None
        self._dst_pos = 0
        self._dst_end = 0
        self.blk = Block("fixed", False)
        self._phase = "first"     # first|ready|flat|need_block|done
        self._flat_rem = 0
        self._bits_rem: int | None = None

    # -- dst management (De.Def.dst, de.mli:398–404) --

    def dst(self, buf: np.ndarray, pos: int = 0, length: int | None = None) -> None:
        buf = np.asarray(buf)
        if buf.dtype != np.uint8:
            raise ValueError("dst buffer must be uint8")
        length = buf.size - pos if length is None else length
        if pos < 0 or length < 0 or pos + length > buf.size:
            raise ValueError("invalid dst range")
        self._dst = buf
        self._dst_pos = pos
        self._dst_end = pos + length

    def dst_rem(self) -> int:
        return self._dst_end - self._dst_pos

    def bits_rem(self) -> int:
        """Padding bits in the final byte; only valid after the last
        block's EOB (de.ml:3012–3015)."""
        if self._bits_rem is None:
            raise ValueError("encoder did not reach EOB of last block")
        return self._bits_rem

    # -- internals --

    def _pump(self) -> bool:
        """Move pending packed bytes into dst; True when fully drained."""
        if self._pending:
            room = self.dst_rem()
            if room <= 0:
                return False
            take = min(room, len(self._pending))
            self._dst[self._dst_pos : self._dst_pos + take] = np.frombuffer(
                self._pending[:take], np.uint8)
            self._dst_pos += take
            self._pending = self._pending[take:]
        return not self._pending

    def _collect(self) -> None:
        self._pending += self._w.take_bytes()

    def _trees(self):
        if self.blk.kind == "dynamic":
            d = self.blk.dynamic
            return (d.lit_codes, d.lit_lengths.astype(np.int64),
                    d.dist_codes, d.dist_lengths.astype(np.int64))
        return (de._fixed_codes_cached()[0], tables.FIXED_LIT_LENGTHS.astype(np.int64),
                de._fixed_codes_cached()[1], tables.FIXED_DIST_LENGTHS[:30].astype(np.int64))

    def _write_header(self, blk: Block) -> None:
        self.blk = blk
        final = 1 if blk.last else 0
        if blk.kind == "fixed":
            self._w.write(final, 1)
            self._w.write(1, 2)
            self._phase = "ready"
        elif blk.kind == "dynamic":
            self._w.write(final, 1)
            self._w.write(2, 2)
            h = blk.dynamic.header
            packed, total = bitstream.pack_bits(h.values, h.nbits)
            self._w.write_packed(packed, total)
            self._phase = "ready"
        else:  # flat: LEN fixed from the queue NOW (de.ml:2674–2681)
            if self.q.ends_with_eob():
                self.q.rem_last_exn()
            self._flat_rem = min(len(self.q), 0xFFFF)
            self._w.write(final, 1)
            self._w.write(0, 2)
            self._w.align_to_byte()
            self._w.write(self._flat_rem, 16)
            self._w.write(self._flat_rem ^ 0xFFFF, 16)
            self._phase = "flat"
        self._collect()

    def _emit_eob(self) -> None:
        lit_codes, lit_bits, _, _ = self._trees()
        self._w.write(int(lit_codes[256]), int(lit_bits[256]))

    def _finish_last(self) -> None:
        # flush the partial byte; bits_rem = its zero-padding width
        nb = self._w.bit_length % 8
        self._bits_rem = (8 - nb) % 8
        self._w.align_to_byte()
        self._collect()
        self._phase = "done"

    def _drain_packed(self) -> str | None:
        """Vector-encode the encodable queue prefix; returns a token to
        surface, or None to keep pumping."""
        cmds = self.q.as_array()
        if cmds.size == 0:
            return None
        lit_codes, lit_bits, dist_codes, dist_bits = self._trees()
        is_copy = (cmds & de._CMD_COPY_FLAG) != 0
        off = (cmds & 0xFFFF) + 1
        ln = ((cmds >> 16) & 0x1FF) + 3
        lsym = np.where(is_copy, 257 + tables.length_to_code(ln), cmds & 0x1FF)
        dcode = tables.dist_to_code(off)
        ok = lit_bits[np.minimum(lsym, 285)] > 0
        ok &= ~is_copy | (dist_bits[dcode] > 0)
        is_eob = cmds == de.CMD_EOB
        stop_bad = np.nonzero(~ok & ~is_eob)[0]
        stop_eob = np.nonzero(is_eob)[0]
        n_bad = int(stop_bad[0]) if stop_bad.size else cmds.size
        n_eob = int(stop_eob[0]) if stop_eob.size else cmds.size
        n = min(n_bad, n_eob)
        if n:
            sel = slice(0, n)
            vals = np.zeros((n, 4), np.uint64)
            nbs = np.zeros((n, 4), np.int64)
            ls = lsym[sel]
            vals[:, 0] = lit_codes[ls]
            nbs[:, 0] = lit_bits[ls]
            cp = is_copy[sel]
            lc = tables.length_to_code(ln[sel])
            dc = dcode[sel]
            vals[cp, 1] = (ln[sel] - tables.LENGTH_BASE[lc])[cp]
            nbs[cp, 1] = tables.LENGTH_EXTRA[lc][cp]
            vals[cp, 2] = dist_codes[dc][cp]
            nbs[cp, 2] = dist_bits[dc][cp]
            vals[cp, 3] = (off[sel] - tables.DIST_BASE[dc])[cp]
            nbs[cp, 3] = tables.DIST_EXTRA[dc][cp]
            packed, total = bitstream.pack_bits(vals.ravel(), nbs.ravel())
            self._w.write_packed(packed, total)
            self.q.junk_exn(n)
            self._collect()
        if n == cmds.size:
            return None  # queue drained
        if n == n_eob:  # EOB command (de.ml:2872–2897)
            self.q.junk_exn(1)
            self._emit_eob()
            if self.blk.last:
                self._finish_last()
                return None
            self._phase = "need_block"
            self._collect()
            return TOKEN_BLOCK
        # unencodable command: EOB, then ask for a new block
        # (de.ml:2851–2871 `Leave`; the command is NOT consumed)
        self._emit_eob()
        self._phase = "need_block"
        self._collect()
        return TOKEN_BLOCK

    def _drain_flat(self) -> str | None:
        take = min(self._flat_rem, len(self.q))
        if take:
            cmds = self.q.as_array()[:take]
            if ((cmds & de._CMD_COPY_FLAG) != 0).any():
                raise ValueError("copy code in flat block can not exist")
            keep = cmds != de.CMD_EOB
            self._w.write_bytes(cmds[keep].astype(np.uint8))
            self.q.junk_exn(take)
            self._flat_rem -= int(keep.sum())
            self._collect()
        if self._flat_rem == 0:
            if self.blk.last:
                self._finish_last()
            else:
                self._phase = "need_block"
                return TOKEN_BLOCK
        return None

    # -- the protocol entry point (De.Def.encode, de.mli:377–396) --

    def encode(self, action) -> str:
        if isinstance(action, Block):
            if self._phase == "done":
                raise ValueError("stream already ended")
            if self._phase in ("first", "need_block"):
                # header only: after a returned "block" the EOB is
                # already written (de.ml:2718–2720 k_nw -> block)
                self._write_header(action)
            else:
                # caller-forced mid-block switch (de.ml:2899–2924 force)
                if self.blk.last:
                    raise ValueError(
                        "impossible to make a new block when the current "
                        "block is the last one")
                if self.blk.kind in ("fixed", "dynamic"):
                    self._emit_eob()
                self._write_header(action)
        elif action == TOKEN_FLUSH or action == TOKEN_AWAIT:
            if self._phase == "first" and action == TOKEN_FLUSH:
                # first_entry with `Flush: open the default fixed block
                # (de.ml:2981–3008)
                self._write_header(self.blk)
            elif self._phase == "need_block" and action == TOKEN_FLUSH:
                if not self._pump():
                    return TOKEN_PARTIAL
                return TOKEN_BLOCK
        else:
            raise ValueError(f"unknown encode action {action!r}")

        while True:
            if not self._pump():
                return TOKEN_PARTIAL
            if self._phase == "ready":
                tok = self._drain_packed()
            elif self._phase == "flat":
                tok = self._drain_flat()
            else:
                return TOKEN_OK
            if tok is not None:
                if not self._pump() and tok == TOKEN_BLOCK:
                    # surface "block" first; pending bytes keep flowing
                    # through the next encode calls
                    return tok
                return tok
            if not self._pending and (
                self._phase in ("ready", "flat") and self.q.is_empty()
                or self._phase == "done"
            ):
                return TOKEN_OK


class QueueDeflate:
    """Raw-DEFLATE push/finish encoder routed through the Lz77 → Queue
    → :class:`Def` protocol (the reference's own consumer loop,
    zl.ml:523–555): first `Flush opens ``block_of_frequencies``, later
    flushes continue it, `Block responses re-negotiate trees, `End
    closes with a ``last=True`` block.

    Same surface as :class:`Deflate` (push/finish) so the zl/gz
    streaming encoders can select either engine.
    """

    def __init__(self, level: int = 6, dynamic: bool = True,
                 q_capacity: int = 1 << 14, *, device="cuda"):
        self.q = Queue(q_capacity)
        self.lz = Lz77(self.q, level, device=device)
        self.enc = Def(self.q)
        self.dynamic = dynamic
        self._first = True
        self._last_pending = False
        self._buf = np.zeros(de.io_buffer_size, np.uint8)
        self.enc.dst(self._buf)
        self._done = False

    def _make_block(self, last: bool = False) -> Block:
        # cumulative frequencies, like the reference (zl.ml:501-507)
        if not self.dynamic:
            return Block("fixed", last)
        return block_of_frequencies(last, self.lz.literals, self.lz.distances)

    def _take(self, out: bytearray) -> None:
        out += bytes(self._buf[: self.enc._dst_pos])
        self.enc.dst(self._buf)

    def _encode(self, action, out: bytearray) -> None:
        tok = self.enc.encode(action)
        while tok != TOKEN_OK:
            if tok == TOKEN_PARTIAL:
                self._take(out)
                tok = self.enc.encode(TOKEN_AWAIT)
            elif tok == TOKEN_BLOCK:
                last = self._last_pending
                tok = self.enc.encode(self._make_block(last))
            else:  # pragma: no cover
                raise AssertionError(tok)

    def _pump(self, out: bytearray) -> None:
        while True:
            tok = self.lz.compress()
            if tok == TOKEN_AWAIT:
                return
            if tok == TOKEN_FLUSH:
                if self._first:
                    self._first = False
                    self._encode(self._make_block(), out)
                else:
                    self._encode(TOKEN_FLUSH, out)
            elif tok == TOKEN_END:
                # the final block: header-only when first, otherwise a
                # forced mid-stream switch (de.ml:2899-2924)
                self._last_pending = True
                self._first = False
                self._encode(self._make_block(last=True), out)
                self._take(out)
                self._done = True
                return

    def push(self, data) -> bytes:
        if self._done:
            raise ValueError("stream already finished")
        out = bytearray()
        self.lz.src(data)
        self._pump(out)
        return bytes(out)

    def finish(self) -> bytes:
        if self._done:
            return b""
        out = bytearray()
        self.lz.src(b"")
        self._pump(out)
        assert self._done
        return bytes(out)

    def bits_rem(self) -> int:
        return self.enc.bits_rem()
