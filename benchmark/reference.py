"""The plain reference that decides ``correct``: a gzip reader written to
RFC 1951 and RFC 1952, and the member index's layout as the archive
format states it.  It imports nothing of the program and takes nothing
the program made except the outputs it judges.

* :func:`check_gzip` judges one one-shot gzip stream against the input it
  was made from: the header the configuration states, every DEFLATE
  block (decoded by Python's ``zlib``, the format's reference inflater),
  the decoded bytes, the CRC-32 and ISIZE trailer, and nothing after it.
* :func:`check_archive` judges an indexed multi-member archive: the
  members in input order, one ``member_size`` slice each, each with its
  own trailer; the FEXTRA index's TZ member sizes; and its TB split
  index.  For the members drawn by the caller, :func:`walk_deflate` (a
  DEFLATE decoder in plain Python that records each command's bit span)
  gives what the TB entry must say exactly: the bit offset of the command
  that holds each multiple of the stride and the largest number of
  commands between two splits.

Each check returns counts of faults by kind; a sound output counts 0 in
each.
"""

from __future__ import annotations

import bisect
import zlib

import numpy as np

FTEXT, FHCRC, FEXTRA, FNAME, FCOMMENT = 1, 2, 4, 8, 16

#: RFC 1951 3.2.5: base lengths and extra bits of symbols 257..285
LEN_BASE = (3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51,
            59, 67, 83, 99, 115, 131, 163, 195, 227, 258)
LEN_EXTRA = (0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4,
             4, 5, 5, 5, 5, 0)
#: base distances and extra bits of distance symbols 0..29
DIST_BASE = (1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385,
             513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385,
             24577)
DIST_EXTRA = (0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9,
              10, 10, 11, 11, 12, 12, 13, 13)
#: order of the code-length code lengths in a dynamic block header
CL_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)

#: the TZ (member sizes) and TB (bit-stride splits) FEXTRA subfields
TZ, TB = b"TZ", b"TB"


class Malformed(ValueError):
    """The stream breaks the format."""


# ---------------------------------------------------------------------------
# gzip members
# ---------------------------------------------------------------------------


def parse_header(buf: bytes, pos: int = 0) -> tuple[dict, int]:
    """The gzip member header at ``pos``: its fields, and the offset of
    the DEFLATE body."""
    if len(buf) < pos + 10 or buf[pos:pos + 2] != b"\x1f\x8b" or buf[pos + 2] != 8:
        raise Malformed("not a gzip member header")
    flg = buf[pos + 3]
    head = {"flags": flg, "mtime": int.from_bytes(buf[pos + 4:pos + 8], "little"),
            "xfl": buf[pos + 8], "os": buf[pos + 9], "extra": None}
    p = pos + 10
    if flg & FEXTRA:
        xlen = int.from_bytes(buf[p:p + 2], "little")
        head["extra"] = bytes(buf[p + 2:p + 2 + xlen])
        if len(head["extra"]) != xlen:
            raise Malformed("FEXTRA runs past the stream")
        p += 2 + xlen
    for flag in (FNAME, FCOMMENT):
        if flg & flag:
            end = buf.find(b"\x00", p)
            if end < 0:
                raise Malformed("unterminated header string")
            p = end + 1
    if flg & FHCRC:
        p += 2
    return head, p


def inflate_member(buf: bytes, body: int) -> tuple[bytes, int]:
    """The DEFLATE body at ``body`` decoded by zlib, and the offset just
    past it (where the trailer starts)."""
    d = zlib.decompressobj(-15)
    try:
        out = d.decompress(memoryview(buf)[body:])
    except zlib.error as e:
        raise Malformed(f"DEFLATE: {e}") from e
    if not d.eof:
        raise Malformed("DEFLATE stream does not end")
    return out, len(buf) - len(d.unused_data)


def header_faults(head: dict, want: dict) -> int:
    """1 where a header field differs from what the configuration states."""
    return int(any(head[k] != v for k, v in want.items()))


def trailer_faults(buf: bytes, at: int, data) -> int:
    """1 where the 8 bytes at ``at`` are not the CRC-32 and ISIZE of
    ``data``."""
    if len(buf) < at + 8:
        return 1
    crc = int.from_bytes(buf[at:at + 4], "little")
    isize = int.from_bytes(buf[at + 4:at + 8], "little")
    return int(crc != zlib.crc32(data) or isize != len(data) & 0xFFFFFFFF)


def check_gzip(out: bytes, data: np.ndarray, header: dict) -> dict:
    """Faults of one one-shot gzip stream made from ``data``."""
    faults = {"header": 0, "bytes": 0, "trailer": 0}
    raw = memoryview(data).cast("B")
    try:
        head, body = parse_header(out)
        faults["header"] = header_faults(head, header)
        decoded, end = inflate_member(out, body)
    except Malformed:
        faults["bytes"] = 1
        return faults
    faults["bytes"] = int(decoded != raw)
    faults["trailer"] = trailer_faults(out, end, raw) or int(len(out) != end + 8)
    return faults


# ---------------------------------------------------------------------------
# the indexed archive
# ---------------------------------------------------------------------------


def subfields(extra: bytes) -> dict[bytes, bytes]:
    """FEXTRA subfields by their two-byte id (RFC 1952 2.3.1.1)."""
    out, i = {}, 0
    while i + 4 <= len(extra):
        ln = int.from_bytes(extra[i + 2:i + 4], "little")
        out[bytes(extra[i:i + 2])] = bytes(extra[i + 4:i + 4 + ln])
        i += 4 + ln
    if i != len(extra):
        raise Malformed("FEXTRA subfields do not tile the field")
    return out


def parse_tb(payload: bytes, members: int) -> tuple[int, list]:
    """The TB subfield: its bit stride and, per member, (row maximum,
    split deltas)."""
    stride = int.from_bytes(payload[:4], "little")
    rows, j = [], 4
    for _ in range(members):
        if j + 4 > len(payload):
            raise Malformed("TB index ends early")
        cnt = int.from_bytes(payload[j:j + 2], "little")
        maxc = int.from_bytes(payload[j + 2:j + 4], "little")
        rows.append((maxc, list(payload[j + 4:j + 4 + cnt])))
        j += 4 + cnt
    if j != len(payload):
        raise Malformed("TB index has bytes past its last member")
    return stride, rows


def expected_tb_row(commands: list, stride: int, n_splits: int, cap: int) -> tuple:
    """What a member's TB entry must hold: the row maximum and the
    deltas ``j * stride - start`` of the command whose bit span holds
    ``j * stride`` (the first command never splits), for j = 1 .. n_splits
    - 1 in turn; ``commands`` are (start bit, bit length) pairs, and the
    end-of-block counts as one more command of the last row."""
    starts = [s for s, _ in commands]
    deltas, owners = [], []
    for j in range(1, n_splits):
        q = j * stride
        c = bisect.bisect_right(starts, q) - 1
        if c <= 0 or q >= starts[c] + commands[c][1]:
            continue
        deltas.append(q - starts[c])
        owners.append(c)
    total = len(commands) + 1
    if not owners:
        return min(total, cap), deltas
    rows = [b - a for a, b in zip([0] + owners, owners + [total])]
    return min(max(rows), cap), deltas


def check_archive(out: bytes, data: np.ndarray, member_size: int, header: dict,
                  index: dict, walk: set) -> dict:
    """Faults of one indexed archive made from ``data``: ``members``
    (a member that does not decode to its slice, in order, or whose
    trailer or header is wrong, or members missing or extra), ``index``
    (TZ sizes that are not the members' sizes, a TB subfield missing or
    malformed) and ``splits`` (a walked member's TB entry that differs
    from what its commands give).  ``walk`` holds the members to walk
    with :func:`walk_deflate`."""
    faults = {"members": 0, "index": 0, "splits": 0}
    raw = memoryview(data).cast("B")
    n = len(raw)
    want = max(1, -(-n // member_size))
    sizes, bodies, pos, extra = [], [], 0, None
    for k in range(want):
        lo, hi = k * member_size, min(n, (k + 1) * member_size)
        try:
            head, body = parse_header(out, pos)
            decoded, end = inflate_member(out, body)
        except Malformed:
            faults["members"] += want - k
            return faults
        if k == 0:
            extra = head["extra"]
            faults["index"] += int(not head["flags"] & FEXTRA)
            head = dict(head, flags=head["flags"] & ~FEXTRA)
        faults["members"] += int(header_faults(head, header) or decoded != raw[lo:hi]
                                 or trailer_faults(out, end, raw[lo:hi]))
        bodies.append((body, end))
        sizes.append(end + 8 - pos)
        pos = end + 8
    faults["members"] += int(pos != len(out))
    try:
        fields = subfields(extra or b"")
        tz = fields[TZ]
        m = int.from_bytes(tz[:4], "little")
        tz_sizes = [int.from_bytes(tz[4 + 4 * k:8 + 4 * k], "little") for k in range(m)]
        faults["index"] += int(m != want or tz_sizes != sizes or len(tz) != 4 + 4 * m)
        stride, rows = parse_tb(fields[TB], want)
    except (KeyError, Malformed):
        faults["index"] += 1
        return faults
    faults["index"] += int(stride != index["split_bits"])
    for k in sorted(walk):
        body, end = bodies[k]
        try:
            commands, decoded = walk_deflate(out[body:end])
        except Malformed:
            faults["splits"] += 1
            continue
        lo = k * member_size
        if commands is None:  # a stored member carries no splits
            ok = rows[k] == (0, []) and decoded == raw[lo:lo + member_size]
        else:
            ok = (rows[k] == expected_tb_row(commands, stride, index["n_splits"],
                                             index["row_cap"])
                  and decoded == raw[lo:lo + member_size])
        faults["splits"] += int(not ok)
    return faults


# ---------------------------------------------------------------------------
# a DEFLATE decoder that records each command's bit span
# ---------------------------------------------------------------------------


def _table(lengths) -> tuple[list, int]:
    """Decode table of canonical Huffman code ``lengths``: entry ``i`` of
    the 2**maxlen-entry list is (symbol, code length) of the code that the
    next maxlen stream bits, least significant first, begin with."""
    maxlen = max(lengths)
    if maxlen == 0:
        return [], 0
    counts = [0] * (maxlen + 1)
    for n in lengths:
        counts[n] += 1
    counts[0] = 0
    code, nxt = 0, [0] * (maxlen + 2)
    for bits in range(1, maxlen + 1):
        code = (code + counts[bits - 1]) << 1
        nxt[bits] = code
    if nxt[maxlen] + counts[maxlen] > (1 << maxlen):
        raise Malformed("over-subscribed code")
    table = [None] * (1 << maxlen)
    for sym, n in enumerate(lengths):
        if n == 0:
            continue
        c = nxt[n]
        nxt[n] += 1
        rev = int(format(c, f"0{n}b")[::-1], 2)
        for fill in range(rev, 1 << maxlen, 1 << n):
            table[fill] = (sym, n)
    return table, maxlen


class _Bits:
    """Least-significant-first bit reader over a byte string."""

    def __init__(self, buf: bytes):
        padded = bytes(buf) + b"\x00" * 8
        w = np.frombuffer(padded, np.uint8).astype(np.uint64)
        words = w[:-7] | (w[1:-6] << 8) | (w[2:-5] << 16) | (w[3:-4] << 24)
        self.words = words.tolist()
        self.nbits = len(buf) * 8
        self.pos = 0

    def peek(self, n: int) -> int:
        return (self.words[self.pos >> 3] >> (self.pos & 7)) & ((1 << n) - 1)

    def read(self, n: int) -> int:
        if self.pos + n > self.nbits:
            raise Malformed("stream ends inside a field")
        v = self.peek(n)
        self.pos += n
        return v

    def symbol(self, table: list, maxlen: int) -> int:
        entry = table[self.peek(maxlen)] if maxlen else None
        if entry is None or self.pos + entry[1] > self.nbits:
            raise Malformed("invalid code")
        self.pos += entry[1]
        return entry[0]


def _dynamic_lengths(r: _Bits) -> tuple[list, list]:
    hlit, hdist, hclen = r.read(5) + 257, r.read(5) + 1, r.read(4) + 4
    cl = [0] * 19
    for i in range(hclen):
        cl[CL_ORDER[i]] = r.read(3)
    table, maxlen = _table(cl)
    lengths: list = []
    while len(lengths) < hlit + hdist:
        sym = r.symbol(table, maxlen)
        if sym < 16:
            lengths.append(sym)
        elif sym == 16:
            if not lengths:
                raise Malformed("repeat with no previous length")
            lengths += [lengths[-1]] * (3 + r.read(2))
        elif sym == 17:
            lengths += [0] * (3 + r.read(3))
        else:
            lengths += [0] * (11 + r.read(7))
    if len(lengths) != hlit + hdist:
        raise Malformed("code lengths overrun")
    return lengths[:hlit], lengths[hlit:]


def _walk_block(r: _Bits, btype: int, out: bytearray, commands: list) -> None:
    """Decode one fixed or dynamic block's symbols into ``out``, each
    literal or match's (start bit, bit length) appended to ``commands``."""
    if btype == 1:
        lit_len = [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8
        dist_len = [5] * 30
    else:
        lit_len, dist_len = _dynamic_lengths(r)
    lit, lmax = _table(lit_len)
    dist, dmax = _table(dist_len)
    while True:
        start = r.pos
        sym = r.symbol(lit, lmax)
        if sym < 256:
            out.append(sym)
        elif sym == 256:
            return
        else:
            if sym > 285:
                raise Malformed("invalid length symbol")
            length = LEN_BASE[sym - 257] + r.read(LEN_EXTRA[sym - 257])
            dsym = r.symbol(dist, dmax)
            if dsym > 29:
                raise Malformed("invalid distance symbol")
            d = DIST_BASE[dsym] + r.read(DIST_EXTRA[dsym])
            if d > len(out):
                raise Malformed("distance before the start")
            if d >= length:
                out += out[len(out) - d:len(out) - d + length]
            else:
                for _ in range(length):
                    out.append(out[-d])
        commands.append((start, r.pos - start))


def walk_deflate(body: bytes) -> tuple[list | None, bytes]:
    """Decode one member's DEFLATE body.  Returns ((start bit, bit length)
    of every command, literal or match, in order, bits counted from the
    body's first; None where every block is stored) and the decoded
    bytes."""
    r = _Bits(body)
    out = bytearray()
    commands: list = []
    coded = False
    while True:
        bfinal, btype = r.read(1), r.read(2)
        if btype == 0:
            r.pos = (r.pos + 7) & ~7
            ln, nln = r.read(16), r.read(16)
            if ln != nln ^ 0xFFFF:
                raise Malformed("stored length")
            start = r.pos >> 3
            out += body[start:start + ln]
            r.pos += 8 * ln
        elif btype in (1, 2):
            coded = True
            _walk_block(r, btype, out, commands)
        else:
            raise Malformed("reserved block type")
        if bfinal:
            return (commands if coded else None), bytes(out)
