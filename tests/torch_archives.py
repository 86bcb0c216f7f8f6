"""Archives rewritten for the port's decode tests."""


def sizes_only(arch: bytes) -> bytes:
    """The sharded archive with its FEXTRA cut to the member-size (TZ)
    subfield: XLEN and the first member's recorded size shrink by the
    bytes removed."""
    xlen = int.from_bytes(arch[10:12], "little")
    assert arch[12:14] == b"TZ"
    tz = 4 + int.from_bytes(arch[14:16], "little")
    out = bytearray(arch[: 12 + tz] + arch[12 + xlen:])
    out[10:12] = tz.to_bytes(2, "little")
    first = int.from_bytes(out[20:24], "little") - (xlen - tz)
    out[20:24] = first.to_bytes(4, "little")
    return bytes(out)
