"""Gzip framing (RFC 1952) over the port's raw DEFLATE.

Counterpart of ``decompress_tpu/gz.py``'s one-shot half: member
compression (:func:`compress`, the DEFLATE body on the card) and the
one-shot decode with its metadata (:func:`decompress`,
:func:`decompress_member`, :func:`decompress_ex`; the body inflated on
the host by ``de.inflate``, as the reference does).  The header layout,
the XFL rule, ``OS``, ``Metadata`` and the error messages are copies of
the reference's (its module imports JAX).  The header CRC, the trailer
CRC-32 and ISIZE are computed on the host by the native library
(``native/``), as the reference computes them.  The streaming ``Inf`` and
``Def`` are not ported yet.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

from . import de, native

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


def compress(data, level: int = 6, *, mtime: int = 0, os: OS | int = OS.default(),
             filename: str | None = None, comment: str | None = None,
             extra: bytes | None = None, fhcrc: bool = False,
             text: bool = False, segment_size: int | None = None,
             device="cuda") -> bytes:
    """One-shot gzip member, byte-identical to
    ``decompress_tpu.gz.compress`` with the same arguments; ``device``
    is where the DEFLATE pipeline runs (see :func:`de.deflate`)."""
    arr = de._np_u8(data)
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
    body = de.deflate(arr, level, segment_size=segment_size, device=device)
    crc = native.crc32(arr)
    isize = arr.size & 0xFFFFFFFF
    return bytes(head) + body + crc.to_bytes(4, "little") + isize.to_bytes(4, "little")


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
