"""Zlib framing (RFC 1950) over the port's raw DEFLATE.

Counterpart of ``decompress_tpu/zl.py``'s one-shot half: the CMF/FLG
header with its FCHECK, an optional preset dictionary (FDICT and its
DICTID), the big-endian Adler-32 trailer, and the window-size
negotiation on decode.  :func:`deflate` runs the DEFLATE body on the card
(``de.deflate``); :func:`inflate` decodes on the host (``de._inflate_ex_arr``),
as the reference does.  The framing's Adler-32 is computed on the host by
the native library (``native/``), as the reference computes it; the
header checks and their messages are the reference's.  The streaming
``Inf`` and ``Def`` are not ported yet.
"""

from __future__ import annotations

from . import de, native


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
