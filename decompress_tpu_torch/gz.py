"""Gzip framing (RFC 1952) over the port's raw DEFLATE.

Counterpart of ``decompress_tpu/gz.py: compress`` (one-shot member
compression).  The header layout and the XFL rule are copies of the
reference's (its module imports JAX); CRC-32 and ISIZE are computed on
the host with ``zlib.crc32``, as the reference computes them on the host
with its native CRC.
"""

from __future__ import annotations

import zlib

import numpy as np

from . import de

_FTEXT, _FHCRC, _FEXTRA, _FNAME, _FCOMMENT = 0x01, 0x02, 0x04, 0x08, 0x10
#: RFC 1952 OS field default (the reference's ``OS.default()``, Unix)
OS_UNIX = 3


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


def compress(data, level: int = 6, *, mtime: int = 0, os: int = OS_UNIX,
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
        head += (zlib.crc32(bytes(head)) & 0xFFFF).to_bytes(2, "little")
    body = de.deflate(arr, level, segment_size=segment_size, device=device)
    crc = zlib.crc32(arr)
    isize = arr.size & 0xFFFFFFFF
    return bytes(head) + body + crc.to_bytes(4, "little") + isize.to_bytes(4, "little")
