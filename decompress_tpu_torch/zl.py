"""Zlib framing (RFC 1950) over the port's raw DEFLATE.

Counterpart of ``decompress_tpu/zl.py``'s one-shot half: the CMF/FLG
header with its FCHECK, an optional preset dictionary (FDICT and its
DICTID), the big-endian Adler-32 trailer, and the window-size
negotiation on decode.  :func:`deflate` runs the DEFLATE body on the card
(``de.deflate``); :func:`inflate` decodes on the host (``de._inflate_ex_arr``),
as the reference does.  The framing's Adler-32 is computed on the host by
the native library (``native/``), as the reference computes it; the
header checks and their messages are the reference's.  The streaming
:class:`Inf` (host) and :class:`Def` (the body on the card, through
``streaming.Deflate`` or, with ``engine="queue"``, ``streaming.QueueDeflate``)
and the ``higher_*`` loops are the reference's streaming classes.
"""

from __future__ import annotations

import copy

from . import de, native, streaming


class MalformedError(de.MalformedError):
    pass


def _flevel(level: int) -> int:
    if level <= 1:
        return 0
    if level <= 5:
        return 1
    if level == 6:
        return 2
    return 3


def _header(level: int, window_bits: int = 15, fdict: bool = False) -> bytes:
    """CMF (CM 8, CINFO from the window) and FLG (FLEVEL, FDICT, FCHECK)."""
    cmf = 0x08 | ((window_bits - 8) << 4)
    flg = (_flevel(level) << 6) | (0x20 if fdict else 0)
    rem = (cmf * 256 + flg) % 31
    if rem:
        flg += 31 - rem
    return bytes([cmf, flg])


def deflate(data, level: int = 6, *, segment_size: int | None = None,
            dynamic: bool = True, window_bits: int = 15,
            zdict: bytes | None = None, strategy: str | None = None,
            device="cuda") -> bytes:
    """One-shot zlib compress, byte-identical to ``decompress_tpu.zl.deflate``
    with the same arguments.  ``dynamic=False`` forces fixed-tree blocks;
    ``window_bits`` (8..15) emits the matching CINFO and restricts match
    distances; ``zdict`` sets FDICT + DICTID and seeds the match window;
    ``device`` is where the DEFLATE pipeline runs (see :func:`de.deflate`)."""
    data = de._np_u8(data)
    body = de.deflate(data, level, segment_size=segment_size, dynamic=dynamic,
                      window_bits=window_bits, dictionary=zdict,
                      strategy=strategy, device=device)
    out = _header(level, window_bits, bool(zdict))
    if zdict:
        out += native.adler32(zdict).to_bytes(4, "big")
    return out + body + native.adler32(data).to_bytes(4, "big")


def inflate(data, *, zdict: bytes | None = None) -> bytes:
    """One-shot zlib decompress."""
    out, _ = inflate_ex(data, zdict=zdict)
    return out


def inflate_ex(data, *, zdict: bytes | None = None) -> tuple[bytes, int]:
    """Decode one zlib stream; returns (payload, bytes consumed).

    ``zdict`` supplies the preset dictionary for FDICT streams (RFC
    1950 §2.2); its Adler-32 is checked against the stream's DICTID."""
    buf = de._np_u8(data)
    if buf.size < 2:
        raise MalformedError("malformed header")
    cmf, flg = int(buf[0]), int(buf[1])
    if (cmf * 256 + flg) % 31 != 0:
        raise MalformedError("invalid header checksum")
    if cmf & 0x0F != 8:
        raise MalformedError("invalid kind of flow")
    if (cmf >> 4) > 7:
        raise MalformedError("invalid window")
    hdr = 2
    window = None
    if flg & 0x20:
        if zdict is None:
            raise MalformedError("unsupported preset dictionary")
        if buf.size < 6:
            raise MalformedError("unexpected end of input")
        dictid = int.from_bytes(buf[2:6].tobytes(), "big")
        if dictid != native.adler32(zdict):
            raise MalformedError("invalid dictionary checksum")
        zd = de._np_u8(zdict)
        window = zd[-min(zd.size, 32768):]
        hdr = 6
    # the Adler runs zero-copy over the decoder's buffer and bytes
    # materialize once on return
    out, consumed = de._inflate_ex_arr(buf[hdr:], window=window,
                                       window_bits=(cmf >> 4) + 8)
    tail = buf[hdr + consumed :]
    if tail.size < 4:
        raise MalformedError("unexpected end of input")
    expect = int.from_bytes(tail[:4].tobytes(), "big")
    if native.adler32(out) != expect:
        raise MalformedError("invalid checksum")
    return out.tobytes(), hdr + consumed + 4


compress = deflate
uncompress = inflate


# ---------------------------------------------------------------------------
# Streaming: the decoder on the host, the encoder's body on the card.
# ---------------------------------------------------------------------------


class Inf:
    """Streaming zlib decoder: header check, raw inflate, Adler verify."""

    def __init__(self, o_size: int = de.io_buffer_size,
                 zdict: bytes | None = None):
        self.o_size = o_size
        self.zdict = zdict
        self._head = b""
        self._inf = None
        self._trailer = b""
        self._adler = 1
        self._phase = "header"
        self._eoi = False
        self.error: str | None = None

    def src(self, data) -> None:
        data = bytes(data)
        if not data:
            self._eoi = True
        if self._phase == "header":
            self._head += data
            if not data and len(self._head) < 2:
                self.error = "unexpected end of input"
                self._phase = "bad"
            return
        if self._phase == "body":
            self._inf.src(data)
            return
        self._trailer += data

    def clone(self) -> "Inf":
        """Snapshot mid-stream: the copy resumes independently."""
        c = copy.copy(self)
        if self._inf is not None:
            c._inf = self._inf.clone()
        return c

    def _start_body(self) -> str | None:
        cmf, flg = self._head[0], self._head[1]
        if (cmf * 256 + flg) % 31 != 0:
            return "invalid header checksum"
        if cmf & 0x0F != 8:
            return "invalid kind of flow"
        if (cmf >> 4) > 7:
            return "invalid window"
        hdr = 2
        window = None
        if flg & 0x20:
            if self.zdict is None:
                return "unsupported preset dictionary"
            if len(self._head) < 6:
                return None if not self._eoi else "unexpected end of input"
            dictid = int.from_bytes(self._head[2:6], "big")
            if dictid != native.adler32(self.zdict):
                return "invalid dictionary checksum"
            window = self.zdict[-32768:]
            hdr = 6
        self._inf = streaming.Inflate(self.o_size, window=window,
                                      window_bits=(cmf >> 4) + 8)
        rest = self._head[hdr:]
        self._head = b""
        if rest:
            self._inf.src(rest)
        return None

    def decode(self) -> str:
        if self._phase == "bad":
            return streaming.TOKEN_MALFORMED
        if self._phase == "header":
            if len(self._head) < 2:
                return streaming.TOKEN_AWAIT
            err = self._start_body()
            if err:
                self.error = err
                self._phase = "bad"
                return streaming.TOKEN_MALFORMED
            if self._inf is None:
                return streaming.TOKEN_AWAIT  # FDICT: waiting for the DICTID bytes
            self._phase = "body"
        if self._phase == "body":
            tok = self._inf.decode()
            if tok == streaming.TOKEN_MALFORMED:
                self.error = self._inf.error
                self._phase = "bad"
                return tok
            if tok != streaming.TOKEN_END:
                return tok
            self._trailer = self._inf.remaining_input() + self._trailer
            self._phase = "trailer"
        if self._phase == "trailer":
            if self._inf._out:
                return streaming.TOKEN_FLUSH  # drain output before END
            if len(self._trailer) < 4:
                if self._eoi:
                    self.error = "unexpected end of input"
                    self._phase = "bad"
                    return streaming.TOKEN_MALFORMED
                return streaming.TOKEN_AWAIT
            expect = int.from_bytes(self._trailer[:4], "big")
            if self._adler != expect:
                self.error = "invalid checksum"
                self._phase = "bad"
                return streaming.TOKEN_MALFORMED
            self._phase = "done"
        return streaming.TOKEN_END

    def flush(self) -> bytes:
        if self._inf is None:
            return b""
        out = self._inf.flush()
        self._adler = native.adler32(out, self._adler)
        return out

    def reset(self) -> None:
        """Reuse for a new stream."""
        self.__init__(self.o_size, zdict=self.zdict)


class Def:
    """Streaming zlib encoder: CMF/FLG header, the DEFLATE body, the
    big-endian Adler-32 trailer (computed on the host)."""

    def __init__(self, level: int = 6, segment_size: int | None = None,
                 engine: str = "segment", *, device="cuda"):
        """``engine="segment"`` encodes whole segments through the device
        pipeline (``streaming.Deflate``); ``engine="queue"`` goes through
        the Lz77 -> Queue -> Def protocol encoder
        (``streaming.QueueDeflate``)."""
        if engine == "queue":
            self._def = streaming.QueueDeflate(level, device=device)
        elif engine == "segment":
            self._def = streaming.Deflate(level, segment_size, device=device)
        else:
            raise ValueError(f"unknown engine {engine!r}")
        self._adler = 1
        self._pending_header = _header(level)

    def push(self, data) -> bytes:
        data = bytes(data)
        self._adler = native.adler32(data, self._adler)
        out = self._pending_header + self._def.push(data)
        self._pending_header = b""
        return out

    def finish(self) -> bytes:
        out = self._pending_header + self._def.finish()
        self._pending_header = b""
        return out + self._adler.to_bytes(4, "big")


def higher_compress(refill, flush, level: int = 6, i_size: int = de.io_buffer_size,
                    *, device="cuda") -> None:
    """camlzip-style compress loop: ``refill()`` returns input chunks
    (b'' = EOF), ``flush(bytes)`` consumes output.  ``i_size`` is taken
    and unused, as in the reference."""
    enc = Def(level, device=device)
    while True:
        chunk = refill()
        if not chunk:
            break
        out = enc.push(chunk)
        if out:
            flush(out)
    flush(enc.finish())


def higher_uncompress(refill, flush, o_size: int = de.io_buffer_size) -> None:
    """camlzip-style uncompress loop, on the host."""
    dec = Inf(o_size)
    while True:
        tok = dec.decode()
        if tok == "await":
            dec.src(refill())
        elif tok == "flush":
            flush(dec.flush())
        elif tok == "end":
            flush(dec.flush())
            return
        else:
            raise MalformedError(dec.error or "malformed")
