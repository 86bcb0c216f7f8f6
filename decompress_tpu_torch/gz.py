"""Gzip framing (RFC 1952) over the port's raw DEFLATE.

Counterpart of ``decompress_tpu/gz.py``'s one-shot half: member
compression (:func:`compress`, the DEFLATE body on the card) and the
one-shot decode with its metadata (:func:`decompress`,
:func:`decompress_member`, :func:`decompress_ex`; the body inflated on
the host by ``de.inflate``, as the reference does).  The header layout,
the XFL rule, ``OS``, ``Metadata`` and the error messages are copies of
the reference's (its module imports JAX).  The header CRC, the trailer
CRC-32 and ISIZE are computed on the host by the native library
(``native/``), as the reference computes them.  The streaming
:class:`Inf` (host, one member per decoder) and :class:`Def` (the body on
the card, through ``streaming.Deflate`` or, with ``engine="queue"``,
``streaming.QueueDeflate``) and the ``higher_*`` loops are the reference's
streaming classes.
"""

from __future__ import annotations

import copy
import enum
from dataclasses import dataclass

import numpy as np

from . import de, native, streaming
from .utils import profiling

_FTEXT, _FHCRC, _FEXTRA, _FNAME, _FCOMMENT = 0x01, 0x02, 0x04, 0x08, 0x10


class MalformedError(de.MalformedError):
    pass


class OS(enum.IntEnum):
    """RFC 1952 OS field."""

    FAT = 0
    AMIGA = 1
    VMS = 2
    UNIX = 3
    VM = 4
    ATARI = 5
    HPFS = 6
    MACINTOSH = 7
    Z_SYSTEM = 8
    CPM = 9
    TOPS_20 = 10
    NTFS = 11
    QDOS = 12
    ACORN = 13
    UNKNOWN = 255

    @classmethod
    def default(cls) -> "OS":
        return cls.UNIX


@dataclass
class Metadata:
    """Per-member gzip metadata."""

    filename: str | None = None
    comment: str | None = None
    mtime: int = 0
    os: OS = OS.UNKNOWN
    extra: bytes | None = None
    text: bool = False

    def extra_field(self, key: bytes) -> bytes | None:
        """Keyed subfield lookup in the FEXTRA field."""
        if self.extra is None or len(key) != 2:
            return None
        buf = self.extra
        i = 0
        while i + 4 <= len(buf):
            si = buf[i : i + 2]
            ln = int.from_bytes(buf[i + 2 : i + 4], "little")
            if si == key:
                return buf[i + 4 : i + 4 + ln]
            i += 4 + ln
        return None


def _xfl(level: int) -> int:
    if level >= 8:
        return 2
    if level <= 2:
        return 4
    return 0


def _header_end(buf: np.ndarray):
    """Offset of the deflate body if the header is complete, else None."""
    if buf.size < 10:
        return None
    flg = int(buf[3])
    pos = 10
    if flg & _FEXTRA:
        if pos + 2 > buf.size:
            return None
        xlen = int.from_bytes(buf[pos : pos + 2].tobytes(), "little")
        pos += 2 + xlen
        if pos > buf.size:
            return None
    for bit in (_FNAME, _FCOMMENT):
        if flg & bit:
            zeros = np.flatnonzero(buf[pos:] == 0)
            if zeros.size == 0:
                return None
            pos += int(zeros[0]) + 1
    if flg & _FHCRC:
        pos += 2
        if pos > buf.size:
            return None
    return pos


def _member_header(level: int, mtime: int, os, filename, comment, extra,
                   fhcrc: bool, text: bool) -> bytes:
    """The member header: magic, CM, FLG, MTIME, XFL, OS, then the
    optional fields and the header CRC."""
    flg = ((_FTEXT if text else 0) | (_FHCRC if fhcrc else 0)
           | (_FEXTRA if extra is not None else 0)
           | (_FNAME if filename is not None else 0)
           | (_FCOMMENT if comment is not None else 0))
    head = bytearray(b"\x1f\x8b\x08")
    head.append(flg)
    head += (mtime & 0xFFFFFFFF).to_bytes(4, "little")
    head.append(_xfl(level))
    head.append(int(os))
    if extra is not None:
        head += len(extra).to_bytes(2, "little")
        head += extra
    if filename is not None:
        head += filename.encode("latin-1") + b"\x00"
    if comment is not None:
        head += comment.encode("latin-1") + b"\x00"
    if fhcrc:
        head += (native.crc32(bytes(head)) & 0xFFFF).to_bytes(2, "little")
    return bytes(head)


def compress(data, level: int = 6, *, mtime: int = 0, os: OS | int = OS.default(),
             filename: str | None = None, comment: str | None = None,
             extra: bytes | None = None, fhcrc: bool = False,
             text: bool = False, segment_size: int | None = None,
             device="cuda") -> bytes:
    """One-shot gzip member, byte-identical to
    ``decompress_tpu.gz.compress`` with the same arguments; ``device``
    is where the DEFLATE pipeline runs (see :func:`de.deflate`)."""
    arr = de._np_u8(data)
    with profiling.span("call"):
        head = _member_header(level, mtime, os, filename, comment, extra, fhcrc, text)
        body = de.deflate(arr, level, segment_size=segment_size, device=device)
        with profiling.span("schedule.assemble"):
            crc = native.crc32(arr)
            isize = arr.size & 0xFFFFFFFF
            return head + body + crc.to_bytes(4, "little") + isize.to_bytes(4, "little")


def _read_zero_terminated(buf: np.ndarray, pos: int) -> tuple[str, int]:
    end = pos
    n = buf.size
    while end < n and buf[end] != 0:
        end += 1
    if end >= n:
        raise MalformedError("unexpected end of input")
    return buf[pos:end].tobytes().decode("latin-1"), end + 1


def decompress_member(data) -> tuple[bytes, Metadata, int]:
    """Decode one gzip member; returns (payload, metadata, consumed)."""
    out, meta, used = _decompress_member_arr(de._np_u8(data))
    return out.tobytes(), meta, used


def _decompress_member_arr(buf: np.ndarray) -> tuple[np.ndarray, Metadata, int]:
    """Member decode keeping the payload as a numpy array: the CRC runs
    zero-copy over the decoder's buffer and callers assemble/materialize
    bytes once at the API boundary."""
    if buf.size < 10:
        raise MalformedError("unexpected end of input")
    if buf[0] != 0x1F or buf[1] != 0x8B:
        raise MalformedError("invalid header")
    if buf[2] != 8:
        raise MalformedError("invalid kind of flow")
    flg = int(buf[3])
    if flg & 0xE0:
        raise MalformedError("invalid flg")
    meta = Metadata(
        mtime=int.from_bytes(buf[4:8].tobytes(), "little"),
        os=OS(int(buf[9])) if int(buf[9]) in OS._value2member_map_ else OS.UNKNOWN,
        text=bool(flg & _FTEXT),
    )
    pos = 10
    if flg & _FEXTRA:
        if pos + 2 > buf.size:
            raise MalformedError("unexpected end of input")
        xlen = int.from_bytes(buf[pos : pos + 2].tobytes(), "little")
        pos += 2
        if pos + xlen > buf.size:
            raise MalformedError("unexpected end of input")
        meta.extra = buf[pos : pos + xlen].tobytes()
        pos += xlen
    if flg & _FNAME:
        meta.filename, pos = _read_zero_terminated(buf, pos)
    if flg & _FCOMMENT:
        meta.comment, pos = _read_zero_terminated(buf, pos)
    if flg & _FHCRC:
        if pos + 2 > buf.size:
            raise MalformedError("unexpected end of input")
        expect = int.from_bytes(buf[pos : pos + 2].tobytes(), "little")
        got = native.crc32(buf[:pos].tobytes()) & 0xFFFF
        if got != expect:
            raise MalformedError("invalid header crc")
        pos += 2
    out, consumed = de._inflate_ex_arr(buf[pos:])
    pos += consumed
    if pos + 8 > buf.size:
        raise MalformedError("unexpected end of input")
    crc_expect = int.from_bytes(buf[pos : pos + 4].tobytes(), "little")
    isize = int.from_bytes(buf[pos + 4 : pos + 8].tobytes(), "little")
    if native.crc32(out) != crc_expect:
        raise MalformedError("invalid checksum")
    if (out.size & 0xFFFFFFFF) != isize:
        raise MalformedError("invalid size")
    return out, meta, pos + 8


def decompress(data) -> bytes:
    """Decode a gzip stream, concatenating all members."""
    buf = de._np_u8(data)
    parts = []
    pos = 0
    while pos < buf.size:
        payload, _, used = _decompress_member_arr(buf[pos:])
        parts.append(payload)
        pos += used
    if not parts:
        raise MalformedError("unexpected end of input")
    if len(parts) == 1:
        return parts[0].tobytes()
    return b"".join(memoryview(p) for p in parts)


def decompress_ex(data) -> tuple[bytes, Metadata]:
    """First member's payload and metadata."""
    payload, meta, _ = decompress_member(data)
    return payload, meta


uncompress = decompress


# ---------------------------------------------------------------------------
# Streaming: the decoder on the host, the encoder's body on the card.
# ---------------------------------------------------------------------------


class Inf:
    """Streaming gzip decoder: one member per decoder (a fresh window per
    member); the metadata is available once the header parses."""

    def __init__(self, o_size: int = de.io_buffer_size):
        self.o_size = o_size
        self._head = bytearray()
        self._inf = None
        self._trailer = b""
        self._crc = 0
        self._isize = 0
        self._phase = "header"
        self._eoi = False
        self.metadata: Metadata | None = None
        self.error: str | None = None

    def src(self, data) -> None:
        data = bytes(data)
        if not data:
            self._eoi = True
        if self._phase == "header":
            self._head += data
        elif self._phase == "body":
            self._inf.src(data)
        else:
            self._trailer += data

    def clone(self) -> "Inf":
        """Snapshot mid-stream: the copy resumes independently."""
        c = copy.copy(self)
        c._head = bytearray(self._head)
        if self._inf is not None:
            c._inf = self._inf.clone()
        return c

    def _try_header(self) -> str | None:
        """Parse the header if it is complete: None when parsed, "await"
        when more bytes are needed, "bad" on a malformed header."""
        buf = np.frombuffer(bytes(self._head), np.uint8)
        if buf.size < 10 or _header_end(buf) is None:
            return "await"
        try:
            meta, body_off = _parse_header(buf)
        except MalformedError as e:
            self.error = str(e)
            return "bad"
        self.metadata = meta
        self._inf = streaming.Inflate(self.o_size)
        rest = bytes(self._head[body_off:])
        self._head = bytearray()
        if rest:
            self._inf.src(rest)
        if self._eoi:
            self._inf.src(b"")
        return None

    def decode(self) -> str:
        if self._phase == "bad":
            return streaming.TOKEN_MALFORMED
        if self._phase == "header":
            r = self._try_header()
            if r == "await":
                if self._eoi:
                    self.error = "unexpected end of input"
                    self._phase = "bad"
                    return streaming.TOKEN_MALFORMED
                return streaming.TOKEN_AWAIT
            if r == "bad":
                self._phase = "bad"
                return streaming.TOKEN_MALFORMED
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
                return streaming.TOKEN_FLUSH
            if len(self._trailer) < 8:
                if self._eoi:
                    self.error = "unexpected end of input"
                    self._phase = "bad"
                    return streaming.TOKEN_MALFORMED
                return streaming.TOKEN_AWAIT
            crc_expect = int.from_bytes(self._trailer[:4], "little")
            isize = int.from_bytes(self._trailer[4:8], "little")
            if self._crc != crc_expect:
                self.error = "invalid checksum"
                self._phase = "bad"
                return streaming.TOKEN_MALFORMED
            if (self._isize & 0xFFFFFFFF) != isize:
                self.error = "invalid size"
                self._phase = "bad"
                return streaming.TOKEN_MALFORMED
            self._phase = "done"
        return streaming.TOKEN_END

    def flush(self) -> bytes:
        if self._inf is None:
            return b""
        out = self._inf.flush()
        self._crc = native.crc32(out, self._crc)
        self._isize += len(out)
        return out

    def remaining_input(self) -> bytes:
        """Bytes after this member (multi-member streams)."""
        return self._trailer[8:] if self._phase == "done" else b""

    def reset(self) -> None:
        """Reuse for the next member (a fresh window), fed the bytes that
        followed this one."""
        rest = self.remaining_input()
        self.__init__(self.o_size)
        if rest:
            self.src(rest)

    # metadata accessors
    def filename(self):
        return self.metadata.filename if self.metadata else None

    def comment(self):
        return self.metadata.comment if self.metadata else None

    def mtime(self):
        return self.metadata.mtime if self.metadata else None

    def os(self):
        return self.metadata.os if self.metadata else None

    def extra(self, key: bytes):
        return self.metadata.extra_field(key) if self.metadata else None


def _parse_header(buf: np.ndarray) -> tuple[Metadata, int]:
    """Full header parse; raises MalformedError. Returns (meta, body_off)."""
    if buf[0] != 0x1F or buf[1] != 0x8B:
        raise MalformedError("invalid header")
    if buf[2] != 8:
        raise MalformedError("invalid kind of flow")
    flg = int(buf[3])
    if flg & 0xE0:
        raise MalformedError("invalid flg")
    meta = Metadata(
        mtime=int.from_bytes(buf[4:8].tobytes(), "little"),
        os=OS(int(buf[9])) if int(buf[9]) in OS._value2member_map_ else OS.UNKNOWN,
        text=bool(flg & _FTEXT),
    )
    pos = 10
    if flg & _FEXTRA:
        xlen = int.from_bytes(buf[pos : pos + 2].tobytes(), "little")
        meta.extra = buf[pos + 2 : pos + 2 + xlen].tobytes()
        pos += 2 + xlen
    if flg & _FNAME:
        meta.filename, pos = _read_zero_terminated(buf, pos)
    if flg & _FCOMMENT:
        meta.comment, pos = _read_zero_terminated(buf, pos)
    if flg & _FHCRC:
        expect = int.from_bytes(buf[pos : pos + 2].tobytes(), "little")
        got = native.crc32(buf[:pos].tobytes()) & 0xFFFF
        if got != expect:
            raise MalformedError("invalid header crc")
        pos += 2
    return meta, pos


class Def:
    """Streaming gzip encoder with the metadata options; the body runs on
    ``device`` (see :class:`streaming.Deflate`)."""

    def __init__(self, level: int = 6, *, mtime: int = 0, os: OS | int = OS.default(),
                 filename: str | None = None, comment: str | None = None,
                 extra: bytes | None = None, fhcrc: bool = False, text: bool = False,
                 segment_size: int | None = None, engine: str = "segment",
                 device="cuda"):
        if engine == "queue":
            self._def = streaming.QueueDeflate(level, device=device)
        elif engine == "segment":
            self._def = streaming.Deflate(level, segment_size, device=device)
        else:
            raise ValueError(f"unknown engine {engine!r}")
        self._crc = 0
        self._isize = 0
        self._pending_header = _member_header(level, mtime, os, filename, comment,
                                              extra, fhcrc, text)

    def push(self, data) -> bytes:
        data = bytes(data)
        self._crc = native.crc32(data, self._crc)
        self._isize += len(data)
        out = self._pending_header + self._def.push(data)
        self._pending_header = b""
        return out

    def finish(self) -> bytes:
        out = self._pending_header + self._def.finish()
        self._pending_header = b""
        return (out + self._crc.to_bytes(4, "little")
                + (self._isize & 0xFFFFFFFF).to_bytes(4, "little"))


def higher_compress(refill, flush, level: int = 6, **meta) -> None:
    """camlzip-style compress loop: ``refill()`` returns input chunks
    (b'' = EOF), ``flush(bytes)`` consumes output; ``meta`` holds
    :class:`Def`'s keyword arguments (``device`` among them)."""
    enc = Def(level, **meta)
    while True:
        chunk = refill()
        if not chunk:
            break
        out = enc.push(chunk)
        if out:
            flush(out)
    flush(enc.finish())


def higher_uncompress(refill, flush, o_size: int = de.io_buffer_size) -> Metadata | None:
    """camlzip-style uncompress loop, on the host; returns the metadata."""
    dec = Inf(o_size)
    while True:
        tok = dec.decode()
        if tok == "await":
            dec.src(refill())
        elif tok == "flush":
            flush(dec.flush())
        elif tok == "end":
            flush(dec.flush())
            return dec.metadata
        else:
            raise MalformedError(dec.error or "malformed")
