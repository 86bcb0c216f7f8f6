"""The member-parallel gzip archive on the card (indexed write and decode),
and the member-parallel zlib stream.

Counterpart of ``decompress_tpu/parallel/sharded.py``.

* :func:`sharded_gzip_compress` splits the input into independent
  members of ``member_size`` bytes (gzip allows concatenated members),
  compresses them in chunks of ``de.MAX_DEVICE_BATCH`` with no history
  (members reset the window) in the reference's windowed order (chunk
  i's analysis is dispatched before chunk i-1's packs are drained),
  records in each packed member the split points of its symbol stream
  (every ``SPLIT_BITS`` bits), and writes member sizes and splits into a
  standard FEXTRA index in the first member's header (the TZ subfield,
  plus the compact TB subfield: one byte per split).  Member CRC-32s are
  computed on the card.  The bytes equal the reference's; any gzip
  reader decodes them.
* :func:`sharded_gzip_decompress` decodes such an archive on the card,
  as the reference's decodes it on its device: every row of every member
  at once (``ops/inflate_cu.decode``), then the rows' commands are
  concatenated per member.  The rows follow the index: with the TB
  subfield, its bit-stride splits; with the legacy TS subfield of
  (bit, command, output) triples, rows between the triples' bit offsets,
  each interior row checked against its recorded command count; with
  no split subfield, or a split index whose offsets do not increase, one
  row a member from its first symbol to the end-of-block.  Members are
  decoded in groups whose command buffer stays under ``GROUP_BYTES``.
  With the reference's default ``expand="auto"`` the compacted stream is
  fetched once and each member is expanded and CRC-checked on the host
  by the native library; with ``expand="device"`` expansion and CRC-32
  stay on the card.

Archives the card path does not cover, as the host reads them from the
index and the block headers before anything goes to the card (no index,
sizes that do not tile the archive, multi-block members, trees too deep
for the decode tables, split bits past a member's body, a row too long
for the decode kernel, or a row command count that saturates the TB
index), take a serial route through the host decoder ``gz.decompress``,
as the reference's do, so a malformed archive there raises the
reference's ``gz.MalformedError`` or ``de.MalformedError`` with its
message.  Each use adds one to ``serial_fallbacks[reason]``, so a
fallback is always visible; the port's own archives never take it.
Members the card rejects after decoding them (a row not decoded, a TS
row off its recorded count, a length or CRC-32 that does not match)
decode again on the card, each as one row to its end-of-block, counted
in ``card_retries``: where the reference decodes such an archive again
serially, this gives its bytes without the host decode.  What the card
still rejects then raises the serial route's error, the reference's; a
host decode never replaces the card's result (:class:`CardFault`).

* :func:`sharded_zlib_compress` writes one zlib stream from members
  compressed as the gzip members are, chained with BFINAL 0 and a sync
  flush (an empty stored block) between them, with the stream's
  Adler-32 computed on the card.

* A mesh (:func:`make_mesh`) is a tuple of ``torch.device``s.  The
  compressors take ``mesh=``: each chunk of ``MAX_DEVICE_BATCH`` members
  per mesh device is split as the reference's ``P("dp")`` shard splits
  it, rows ``[8k, 8k + 8)`` to device k, each device's rows analysed and
  packed there, and the members gathered on the host by index, so the
  archive is byte-identical for any mesh.  One host thread dispatches
  every device's groups in turn, and round A is host-bound (thousands
  of small launches a group), so an in-process mesh gives the same
  bytes but no speedup over one card.  To scale across cards, run one
  process per card: ``parallel.multihost.sharded_gzip_compress_multihost``.
* :func:`compress_step_sharded` runs the fixed-Huffman device step
  (``ops/pipeline.fixed_deflate_segments``) over a mesh with the
  reference's output layout (its all-gathered sizes and summed bits).
"""

from __future__ import annotations

import collections
import typing

import numpy as np
import torch

from .. import de, gz, native, zl
from ..core import bitstream, huffman
from ..ops import checksum, inflate, inflate_cu, lz77, pipeline, transfer
from ..utils import profiling

INDEX_ID = b"TZ"  # gzip FEXTRA subfield carrying member byte sizes
SPLIT_ID = b"TS"  # FEXTRA subfield: per-member symbol-stream split points
TBITS_ID = b"TB"  # compact bit-stride splits: u8 deltas off j*SPLIT_BITS

#: split points recorded per member, at most (N_SPLITS - 1 interior ones)
N_SPLITS = 250
#: command stride of the legacy split geometry (used when SPLIT_BITS == 0)
SPLIT_STRIDE = 2048
#: bit stride of the split points: every row spans at most SPLIT_BITS + 48
#: stream bits
SPLIT_BITS = 8192
#: the TB index's u16 commands-per-row field saturates here
TB_CMDS_CAP = 65535
#: command-buffer bytes (rows x max_cmds x 4) of one decode launch, at most:
#: consecutive members are decoded in groups under it (a member whose own
#: rows pass it is a group alone)
GROUP_BYTES = 1 << 30

#: serial-route uses by reason; stays empty for the port's own archives
serial_fallbacks: collections.Counter = collections.Counter()
#: archives whose rejected members were decoded again as whole-member
#: rows on the card, by the first reject's reason
card_retries: collections.Counter = collections.Counter()
#: indexes written by subfield (``tb``, ``ts``, ``sizes_only``, and
#: ``none`` where the archive has too many members for one) and the
#: members of those archives (``members``)
INDEX_COUNTS: collections.Counter = collections.Counter()


def make_mesh(n_devices: int | None = None, device="cuda") -> tuple:
    """A mesh: the first ``n_devices`` cards (all of them by default) as a
    tuple of ``torch.device``s, or with ``device="cpu"`` that many CPU
    handles (default 1), the counterpart of the reference's virtual CPU
    devices.  Raises ``ValueError`` where there are fewer cards, and
    without CUDA where ``device`` is "cuda".  Any tuple of devices is a
    mesh, one card repeated included."""
    dev = de._resolve_device(device)
    if dev.type == "cpu":
        return (dev,) * (1 if n_devices is None else n_devices)
    have = torch.cuda.device_count()
    n = have if n_devices is None else n_devices
    if have < n:
        raise ValueError(f"need {n} devices, have {have}")
    return tuple(torch.device("cuda", i) for i in range(n))


def _mesh_devices(mesh, device) -> tuple:
    """The resolved devices of ``mesh`` (a sequence of devices), or of
    ``device`` alone where ``mesh`` is None."""
    devs = tuple(de._resolve_device(d) for d in ((device,) if mesh is None else mesh))
    if not devs:
        raise ValueError("empty mesh")
    return devs


def _shard_rows(lo: int, m: int, d: int) -> list:
    """The chunk of members from ``lo`` split over a mesh of ``d``
    devices, as the reference's ``_shard_batch`` splits it: the chunk is
    MAX_DEVICE_BATCH * d members, a tail chunk of b is padded to max(d,
    2^ceil(log2 b)) rows and then to a multiple of d, and device k takes
    the k-th run of rows.  Returns (device index, first member, valid
    rows, rows) for each device that holds a valid row."""
    chunk = de.MAX_DEVICE_BATCH * d
    hi = min(lo + chunk, m)
    b = hi - lo
    b_pad = chunk if b == chunk else max(d, 1 << (b - 1).bit_length())
    rows = -(-b_pad // d)
    return [(k, lo + k * rows, min(rows, hi - lo - k * rows), rows)
            for k in range(d) if k * rows < b]


def _compress_members(arr, level, member_size, mesh, final_flags=None,
                      want_crc=True, shared_tree=False):
    """Member compression over ``mesh`` (a tuple of devices), in chunks of
    MAX_DEVICE_BATCH members per mesh device split as :func:`_shard_rows`
    splits them, each device group one ``de.Batch`` of history-free rows;
    member i is a final block where ``final_flags[i]`` (default: every
    member).

    Returns (parts, n_valid): parts[i] is member i's ``de.Part``, packed
    ones with their N_SPLITS-1 split points (bit_off 0 = none), and with
    ``want_crc`` every one with its CRC-32 computed on its device.

    Chunks run in the reference's windowed order: chunk i's round A is
    dispatched on every device group, then chunk i-1's packs are drained
    (``de.drain``) while the devices work on i, then chunk i is finished
    (repairs, round B) and its packs dispatched, each with its members'
    CRC-32 and the copies of what the drain reads queued behind it.  At
    most two chunks' device buffers are live.  ``shared_tree`` analyzes
    every chunk first, sums the histograms, builds one dynamic tree and
    packs every member with it."""
    devs = tuple(mesh)
    m = max(1, (arr.size + member_size - 1) // member_size)
    n_valid = np.minimum(arr.size - np.arange(m) * member_size, member_size).astype(np.int32)
    if final_flags is None:
        final_flags = np.ones(m, bool)
    chunk = de.MAX_DEVICE_BATCH * len(devs)
    parts: list = []

    @profiling.spanned("schedule.stage")
    def start(k, glo, b, rows):
        # members are independent (window reset at boundaries), so they run
        # with no history prefix
        members = [arr[i * member_size:(i + 1) * member_size] for i in range(glo, glo + b)]
        return de.Batch(de.batch_rows(members, None, member_size, rows=rows), devs[k],
                        first=glo).start(level)

    def analyze(lo):  # round A of every device group of the chunk at lo
        return [start(*g) for g in _shard_rows(lo, m, len(devs))]

    def pack(batch, shared=False):
        return batch.pack(final_flags[batch.first:batch.first + batch.rows.b],
                          shared_tree=shared, n_splits=N_SPLITS,
                          split_stride=SPLIT_STRIDE, split_bits=SPLIT_BITS, crc=want_crc)

    def drain(batches):  # device groups come in member order
        with profiling.span("schedule.assemble"):
            parts.extend(de.drain(batches))

    if shared_tree:
        staged = [p.finish() for lo in range(0, m, chunk) for p in analyze(lo)]
        hl_sum = sum(batch.hist_lit.astype(np.int64).sum(axis=0) for batch in staged)
        hd_sum = sum(batch.hist_dist.astype(np.int64).sum(axis=0) for batch in staged)
        hl_sum[de.EOB] += m  # one EOB per member block
        s_lit = huffman.code_lengths_from_frequencies(hl_sum)
        s_dist = huffman.code_lengths_from_frequencies(hd_sum)
        shared = (s_lit, s_dist, de.build_dynamic_header(s_lit, s_dist))
        for batch in staged:
            drain([pack(batch, shared)])
    else:
        packed = None
        for lo in range(0, m, chunk):
            pend = analyze(lo)
            if packed is not None:  # chunk i-1, while the devices analyze chunk i
                drain(packed)
            packed = [pack(batch) for batch in [p.finish() for p in pend]]
        drain(packed)
    return parts, n_valid


def sharded_gzip_compress(data, level: int = 6, *, member_size: int = de.SEGMENT_SIZE,
                          mesh=None, mtime: int = 0, os: gz.OS | int = gz.OS.default(),
                          index: bool = True, return_meta: bool = False,
                          shared_tree: bool = False, config=None, device="cuda"):
    """Multi-member gzip archive, members compressed in parallel on
    ``device``, or over ``mesh`` where one is given; byte-identical to the
    reference's ``sharded_gzip_compress`` with the same arguments, for any
    mesh.  With ``index`` (the default) the first member's FEXTRA lists
    the member sizes and split points so :func:`sharded_gzip_decompress`
    can decode all members in parallel; other gzip readers ignore it.

    ``return_meta`` returns (archive, sizes, split_rows, ncmds), the
    per-member inputs of :func:`_build_index` (what the multi-process
    writer gathers).  A ``config`` (``utils.config.CodecConfig``,
    validated first) supplies the level where ``level`` is 6, the member
    size, ``shared_tree`` and ``write_index``, and its device where
    ``device`` is left at "cuda"."""
    if config is not None:
        config.validate()
        level = config.level if level == 6 else level
        member_size = config.member_size or member_size
        index = index and config.write_index
        shared_tree = shared_tree or config.shared_tree
        device = config.device if device == "cuda" else device
    devs = _mesh_devices(mesh, device)
    arr = de._np_u8(data)
    with profiling.span("call"):
        if arr.size == 0:
            empty = gz.compress(b"", level, device=devs[0])
            return (empty, [len(empty)], [[(0, 0, 0)] * (N_SPLITS - 1)], [0]) \
                if return_meta else empty
        parts, n_valid = _compress_members(arr, level, member_size, devs,
                                           shared_tree=shared_tree)
        return _assemble(parts, n_valid, level, mtime, os, index, return_meta)


@profiling.spanned("schedule.assemble")
def _assemble(parts, n_valid, level, mtime, os, index, return_meta):
    """The archive, or with ``return_meta`` the tuple
    :func:`sharded_gzip_compress` returns, from the members' parts (with
    their CRC-32s) and sizes (:func:`_compress_members`)."""
    m = len(parts)
    head = b"\x1f\x8b\x08\x00" + (mtime & 0xFFFFFFFF).to_bytes(4, "little") \
        + bytes([gz._xfl(level), int(os)])
    bodies = []
    for part in parts:
        w = bitstream.BitWriter()
        de.write_parts(w, [part])
        bodies.append(w.getvalue())

    sizes = [len(head) + len(b) + 8 for b in bodies]
    split_rows = np.zeros((m, N_SPLITS - 1, 3), np.int64)  # all-zero for stored members
    for i, part in enumerate(parts):
        if part.splits is not None:
            split_rows[i] = part.splits
    ncmds = [part.ncmds for part in parts]
    xt = _build_index(m, sizes, split_rows, ncmds) if index else None
    if xt is not None:
        head0 = bytearray(head)
        head0[3] |= gz._FEXTRA
        heads = [bytes(head0) + xt] + [head] * (m - 1)
    else:
        heads = [head] * m
    out = []
    for i in range(m):  # order-preserving: by member index
        out.append(heads[i])
        out.append(bodies[i])
        out.append(parts[i].crc.to_bytes(4, "little"))
        out.append(int(int(n_valid[i]) & 0xFFFFFFFF).to_bytes(4, "little"))
    archive = b"".join(out)
    if return_meta:
        triples = [list(zip(*r)) for r in split_rows.transpose(0, 2, 1).tolist()]
        return archive, sizes, triples, ncmds
    return archive


def sharded_zlib_compress(data, level: int = 6, *, member_size: int = de.SEGMENT_SIZE,
                          mesh=None, device="cuda") -> bytes:
    """One zlib stream from members compressed in parallel on ``device``,
    or over ``mesh`` where one is given; byte-identical to the reference's
    ``sharded_zlib_compress`` with the same arguments, for any mesh.
    Members are raw blocks with no shared window, all but the last with
    BFINAL 0 and each packed one followed by a sync flush (an empty
    stored block) so the next starts on a byte; the stream's Adler-32 is
    computed on the first device."""
    devs = _mesh_devices(mesh, device)
    arr = de._np_u8(data)
    if arr.size == 0:
        return zl.deflate(b"", level, device=devs[0])
    m = max(1, (arr.size + member_size - 1) // member_size)
    final_flags = np.zeros(m, bool)
    final_flags[-1] = True
    parts, _ = _compress_members(arr, level, member_size, devs,
                                 final_flags=final_flags, want_crc=False)
    # members tile the input in order, so the stream's Adler-32 is that
    # of the whole input
    adler = checksum.adler32(arr, device=devs[0])
    w = bitstream.BitWriter()
    w.write_bytes(zl._header(level))
    de.write_parts(w, parts, sync=True)
    return w.getvalue() + adler.to_bytes(4, "big")


def _encode_tb(splits: np.ndarray, ncmds: np.ndarray, stride: int) -> bytes | None:
    """Compact TB payload of the [m, N_SPLITS - 1, 3] int64 ``splits``, or
    None when any split point doesn't fit the delta encoding (e.g.
    command-stride archives)."""
    m = len(splits)
    bits, cis = splits[..., 0], splits[..., 1]
    valid = bits > 0
    rank = np.cumsum(valid, axis=1)  # a valid triple's 1-based rank in its row
    owner = np.nonzero(valid)[0]  # member of each valid triple, in order
    rank_v = rank[valid]
    deltas = rank_v * stride - bits[valid]
    if deltas.size and (deltas.min() < 0 or deltas.max() > 255):
        return None
    count = rank[:, -1]
    start = np.cumsum(count) - count  # each row's first valid triple
    has = count > 0
    first = start[has]
    ci = cis[valid]
    step = np.diff(ci, prepend=0)
    step[first] = ci[first]  # a row's first step is from 0
    maxc = ncmds.copy()  # a row with no valid triple: its command count
    if first.size:
        top = np.maximum(np.maximum.reduceat(step, first), 0)
        final = ncmds[has] - ci[first + count[has] - 1]
        maxc[has] = np.where(ncmds[has] != 0, np.maximum(top, final), top)
    maxc = np.minimum(maxc, TB_CMDS_CAP)
    # per member: u16 count, u16 max commands a row, count u8 deltas
    rec = 4 + 4 * np.arange(m) + start
    out = np.empty(4 + 4 * m + int(count.sum()), np.uint8)
    out[:4] = np.frombuffer(int(stride).to_bytes(4, "little"), np.uint8)
    for k, v in enumerate((count, count >> 8, maxc, maxc >> 8)):
        out[rec + k] = v & 0xFF
    out[rec[owner] + 3 + rank_v] = deltas
    return out.tobytes()


def _build_index(m: int, sizes, split_rows, ncmds=None) -> bytes | None:
    """FEXTRA bytes (XLEN + subfields) for the member index, or None.

    ``sizes`` are per-member byte sizes excluding the index field itself
    (the first member's recorded size grows by the field's length);
    ``split_rows`` holds N_SPLITS - 1 (bit, cmd, out) triples per member
    (all-zero for stored members).  Each is a list or an int64 array
    ([m], [m, N_SPLITS - 1, 3], [m]).  With bit-stride splits and
    ``ncmds`` the splits go into the compact TB subfield: u32 stride, then
    per member a u16 count, a u16 maximum of commands per row and count
    u8 deltas; otherwise into the legacy TS subfield of 12-byte triples.
    Counts each call in :data:`INDEX_COUNTS`.
    """
    if m > (65531 - 8) // 4:
        INDEX_COUNTS.update(none=1, members=m)
        return None
    splits = np.asarray(split_rows, np.int64).reshape(m, -1, 3)
    tb = None
    if SPLIT_BITS > 0 and ncmds is not None:
        tb = _encode_tb(splits, np.asarray(ncmds, np.int64), SPLIT_BITS)
    xdata_len = 4 + 4 * m
    extra_len = 2 + 4 + xdata_len
    sfield = b""
    if tb is not None and 4 + xdata_len + 4 + len(tb) <= 65535:
        sfield = TBITS_ID + len(tb).to_bytes(2, "little") + tb
        extra_len += len(sfield)
        kind = "tb"
    else:
        # legacy 12-byte triples, one global subfield
        split_len = 1 + m + 12 * int((splits[..., 0] > 0).sum())
        kind = "ts" if 4 + (4 + 4 * m) + (4 + split_len) <= 65535 else "sizes_only"
    if kind == "ts":
        # count-prefixed valid triples per member (bit offset 0 = unused)
        parts_enc = []
        for row in splits.tolist():
            valid = [t for t in row if t[0] > 0]
            parts_enc.append(bytes([len(valid)]) + b"".join(
                bo.to_bytes(4, "little") + ci.to_bytes(4, "little")
                + oo.to_bytes(4, "little") for (bo, ci, oo) in valid))
        sdata = bytes([N_SPLITS]) + b"".join(parts_enc)
        sfield = SPLIT_ID + len(sdata).to_bytes(2, "little") + sdata
        extra_len += len(sfield)
    INDEX_COUNTS.update({kind: 1, "members": m})
    sizes = np.array(sizes, np.int64)
    sizes[0] += extra_len  # first member grows by the FEXTRA
    if sizes.min() < 0 or sizes.max() > 0xFFFFFFFF:
        raise OverflowError("a member size outside the index's u32 field")
    xfield = INDEX_ID + xdata_len.to_bytes(2, "little") \
        + m.to_bytes(4, "little") + sizes.astype("<u4").tobytes() + sfield
    return len(xfield).to_bytes(2, "little") + xfield


def _read_index_ex(buf: np.ndarray):
    """(member sizes, per-member split triples, tb meta) from the FEXTRA
    index.

    Legacy splits (TS subfield) are (bit_off, cmd_idx, out_off) triples
    per interior row boundary.  Compact bit-stride splits (TB) come back
    as synthesized (bit_off, 0, 0) triples plus ``tb = {"bits": stride,
    "max_cmds": [per member]}``: their rows stop by bit position.  (None,
    None, None) when the archive has no index; raises de.MalformedError
    on a buffer that is not gzip.
    """
    if buf.size < 12 or buf[0] != 0x1F or buf[1] != 0x8B:
        raise de.MalformedError("invalid header")
    if not (int(buf[3]) & gz._FEXTRA):
        return None, None, None
    xlen = int.from_bytes(buf[10:12].tobytes(), "little")
    field = buf[12 : 12 + xlen].tobytes()
    i = 0
    sizes = None
    splits = None
    tb = None
    while i + 4 <= len(field):
        sid = field[i : i + 2]
        ln = int.from_bytes(field[i + 2 : i + 4], "little")
        data = field[i + 4 : i + 4 + ln]
        if sid == TBITS_ID and len(data) >= 4:
            stride = int.from_bytes(data[:4], "little")
            rows_out = []
            maxes = []
            j = 4
            bad = stride <= 0
            while not bad and j + 4 <= len(data):
                cnt = int.from_bytes(data[j : j + 2], "little")
                maxc = int.from_bytes(data[j + 2 : j + 4], "little")
                j += 4
                if j + cnt > len(data):
                    bad = True
                    break
                rows_out.append([
                    ((k + 1) * stride - data[j + k], 0, 0)
                    for k in range(cnt)
                ])
                maxes.append(maxc)
                j += cnt
            if not bad and rows_out:
                splits = rows_out
                tb = {"bits": stride, "max_cmds": maxes}
        elif sid == INDEX_ID:
            m = int.from_bytes(data[:4], "little")
            if len(data) != 4 + 4 * m:
                return None, None, None
            sizes = [
                int.from_bytes(data[4 + 4 * k : 8 + 4 * k], "little")
                for k in range(m)
            ]
        elif sid == SPLIT_ID and len(data) >= 1:
            ns = data[0]
            rows_out = []
            j = 1
            bad = ns < 2
            while j < len(data):
                nvalid = data[j]
                j += 1
                if nvalid > ns - 1 or j + 12 * nvalid > len(data):
                    bad = True
                    break
                row = []
                for _ in range(nvalid):
                    row.append((
                        int.from_bytes(data[j : j + 4], "little"),
                        int.from_bytes(data[j + 4 : j + 8], "little"),
                        int.from_bytes(data[j + 8 : j + 12], "little"),
                    ))
                    j += 12
                rows_out.append(row)
            if not bad and rows_out:
                splits = rows_out
        i += 4 + ln
    return sizes, splits, tb


class _Serial(Exception):
    """The archive takes the serial route; the message is the reason."""


class CardFault(RuntimeError):
    """The card decode rejected members of an archive that the host
    decoder accepts: a fault of the decode, not of the archive."""


def _serial(buf: np.ndarray, reason: str) -> bytes:
    """Serial decode of concatenated gzip members on the host
    (``gz.decompress``, as the reference's serial route); counts the use
    under ``reason``."""
    serial_fallbacks[reason] += 1
    return gz.decompress(buf)


def _card_reject(buf: np.ndarray, reason: str):
    """The reference's error for an archive with members the card
    rejected even as whole-member rows: the serial route raises it.
    Raises CardFault where that route decodes the archive instead, since
    a result is never replaced by a host decode once the card has run."""
    _serial(buf, reason)
    raise CardFault(f"{reason} on the card, but the host decoder accepts the archive")


class DecodePlan(typing.NamedTuple):
    """The host half of a decode (:func:`decode_plan`).

    ``metas[i]`` = (prepared member, body, crc, isize) of every member;
    ``huff`` the members decoded on the card; for the k-th of them,
    ``rows[k]`` the (start, stop) bits of its rows (stop 0 = to
    end-of-block), ``counts[k]`` each row's recorded command count (-1
    where the index records none) and ``caps[k]`` the most commands one
    of its rows may hold."""

    metas: list
    huff: list
    rows: list
    caps: list
    counts: list

    def max_cmds(self, lo: int = 0, hi: int | None = None) -> int:
        """The row capacity of one decode launch over members
        ``huff[lo:hi]``: their largest cap plus 4."""
        return max(self.caps[lo:hi]) + 4


def _split_kind(metas, huff, splits, tb) -> str:
    """How the index splits the decoded members, as the reference reads
    it: "tb" (bit-stride), "ts" (legacy triples) or "whole" (no split
    subfield, one that does not list every member, or one whose bit
    offsets, or for TS commands, do not increase or whose output offsets
    pass the member: one row a member)."""
    if splits is None or len(splits) != len(metas):
        return "whole"
    kind = "ts" if tb is None else "tb"
    for i in huff:
        prev_bit, prev_cmd, isize = metas[i][0][3], 0, metas[i][3]
        for bo, ci, oo in (t for t in splits[i] if t[0] > 0):
            if bo <= prev_bit or (kind == "ts" and (ci <= prev_cmd or oo > isize)):
                return "whole"
            prev_bit, prev_cmd = bo, ci
    return kind


@profiling.spanned("decode.plan", cpu=True)
def decode_plan(buf: np.ndarray) -> DecodePlan:
    """Host half of the decode: parse the index and every member's block
    header, and lay out the rows (:func:`_layout`).  Raises _Serial for
    what the card path does not cover: no index, sizes that do not tile
    the archive, a member that is not one block the decode tables hold,
    and the row faults :func:`_layout` finds."""
    try:
        sizes, splits, tb = _read_index_ex(buf)
    except (de.MalformedError, ValueError) as e:
        raise _Serial("not gzip") from e
    if sizes is None:
        raise _Serial("no member index")
    members = []
    off = 0
    for s in sizes:
        members.append(buf[off : off + s])
        off += s
    if off != buf.size:
        raise _Serial("index sizes do not tile the archive")
    metas = []
    try:
        for mem in members:
            body_off = gz._header_end(mem)
            if body_off is None:
                raise inflate.NotParallelizable("bad header")
            body = mem[body_off:-8]
            crc = int.from_bytes(mem[-8:-4].tobytes(), "little")
            isize = int.from_bytes(mem[-4:].tobytes(), "little")
            metas.append((inflate.prepare_member(body), body, crc, isize))
    except (inflate.NotParallelizable, de.MalformedError, EOFError) as e:
        raise _Serial("member not device-decodable") from e
    if not all(inflate_cu.tables_fit(p[1], p[2]) for p, *_rest in metas
               if p[0] == "huff"):
        raise _Serial("member not device-decodable")
    huff = [i for i, (p, *_rest) in enumerate(metas) if p[0] == "huff"]
    if not huff:
        return DecodePlan(metas, huff, [], [], [])
    kind = _split_kind(metas, huff, splits, tb)
    tri = {i: [] if kind == "whole" else [t for t in splits[i] if t[0] > 0] for i in huff}
    return _layout(metas, huff, tri, kind, tb)


def _layout(metas: list, huff: list, tri: dict, kind: str, tb=None) -> DecodePlan:
    """The rows of members ``huff``, split at their triples ``tri[i]``,
    with the reference's caps: a TB row holds at most its member's
    recorded row maximum, or else the largest of any member, or else
    ``isize + 2``; a TS row its recorded count; a member's final row
    ``isize`` minus its last split's output offset plus 2, and with
    splits at most the largest row count plus 4.  No row holds more than
    its bit length plus 2, as each command takes a bit at least, so an
    ``isize`` the trailer overstates sizes no buffer.  Raises _Serial for
    split bits outside a member's body, a row longer than
    ``inflate_cu.MAX_ROW_BITS``, and a member whose recorded row maximum
    is the TB field's saturated ``TB_CMDS_CAP``."""
    # the largest command count between consecutive splits: the TB
    # field's row maxima, or the TS triples' command steps
    stride_cap = 0
    if kind == "tb":
        stride_cap = max(tb["max_cmds"][i] for i in huff)
    elif kind == "ts":
        stride_cap = max((b[1] - a[1] for i in huff
                          for a, b in zip([(0, 0, 0)] + tri[i], tri[i])), default=0)
    rows, caps, counts = [], [], []
    for i in huff:
        start, end, isize = metas[i][0][3], metas[i][1].size * 8, metas[i][3]
        bits = [start] + [t[0] for t in tri[i]]
        if bits[-1] >= end:
            raise _Serial("split bits past a member's body")
        spans = [b - a for a, b in zip(bits, bits[1:] + [end])]
        if max(spans) > inflate_cu.MAX_ROW_BITS:
            raise _Serial("row longer than the decode kernel's bit range")
        cmd = [0] + [t[1] for t in tri[i]]
        count = [b - a for a, b in zip(cmd, cmd[1:])] if kind == "ts" else [-1] * len(tri[i])
        interior = ([tb["max_cmds"][i] or stride_cap or isize + 2] * len(tri[i])
                    if kind == "tb" else count)
        final = isize - (tri[i][-1][2] if tri[i] else 0) + 2  # commands <= bytes + EOB
        if stride_cap:
            final = min(final, stride_cap + 4)
        rows.append(list(zip(bits, bits[1:] + [0])))
        caps.append(max(min(c, n + 2) for c, n in zip(interior + [final], spans)))
        counts.append(count + [-1])
    if kind == "tb" and stride_cap >= TB_CMDS_CAP:
        # the writer saturates the field: the real count is unknown
        raise _Serial("row command count over the index's u16 cap")
    return DecodePlan(metas, huff, rows, caps, counts)


def _groups(plan: DecodePlan) -> list:
    """Consecutive (first, end) ranges of ``plan.huff`` whose command
    buffer, rows x (largest cap + 4) x 4 bytes, stays under
    ``GROUP_BYTES``; a member past it alone is a group of its own."""
    groups, lo, nrows, cap = [], 0, 0, 0
    for k, (rows, c) in enumerate(zip(plan.rows, plan.caps)):
        if k > lo and (nrows + len(rows)) * (max(cap, c) + 4) * 4 > GROUP_BYTES:
            groups.append((lo, k))
            lo, nrows, cap = k, 0, 0
        nrows += len(rows)
        cap = max(cap, c)
    return groups + [(lo, len(plan.rows))] if plan.rows else []


def sharded_gzip_decompress(archive, *, expand: str = "auto", device="cuda") -> bytes:
    """Member-parallel decode of an indexed archive on ``device``; stored
    members resolve on the host.

    Every row of every member decodes on ``device``, in groups of
    members (:data:`GROUP_BYTES`), and each group's commands are
    compacted there.  ``expand`` says where they become bytes, with the
    reference's meaning and default: ``"device"`` expands them and checks
    each member's CRC-32 on ``device`` (``inflate.expand_commands``,
    ``crc32_rows``); any other value, ``"auto"`` included, fetches each
    group's compacted stream once and expands each member on the host
    (``native.expand_cmds``), checked by length and ``native.crc32``.  The
    reference's "auto" takes the host route where its native library
    loads; the port's library builds or raises, so "auto" always takes it.

    Archives the device path does not cover, as :func:`decode_plan` finds
    before anything is staged, take the serial host route as the
    reference's do, counted in ``serial_fallbacks``; malformed input
    there raises the reference's ``gz.MalformedError`` or
    ``de.MalformedError`` and message.  Members the card rejects after
    the decode (a row not ok or off its recorded TS count, a length or
    CRC-32 that does not match) decode again on ``device``, each as one
    row to its end-of-block, counted in ``card_retries``; where the
    reference decodes the archive again serially, this gives its bytes.
    Members still rejected then, and stored members that do not match,
    raise the serial route's error, the reference's, or
    :class:`CardFault` where that route decodes the archive."""
    dev = de._resolve_device(device)
    buf = de._np_u8(archive)
    with profiling.span("call"):
        try:
            return _decode_on_device(buf, dev, expand)
        except _Serial as e:
            return _serial(buf, str(e))


def _decode_on_device(buf: np.ndarray, dev: torch.device, expand: str) -> bytes:
    plan = decode_plan(buf)
    results: list = [None] * len(plan.metas)
    reasons = _decode_groups(plan, dev, expand, results)
    again = [i for i in plan.huff if results[i] is None]
    if again:
        card_retries[reasons[0]] += 1
        # one row to end-of-block depends on no split the index records
        fit = [i for i in again
               if 0 < plan.metas[i][1].size * 8 - plan.metas[i][0][3] <= inflate_cu.MAX_ROW_BITS]
        if fit:
            whole = _layout(plan.metas, fit, {i: [] for i in fit}, "whole")
            _decode_groups(whole, dev, expand, results)
    with profiling.span("schedule.assemble"):
        for i, (p, _, crc, isize) in enumerate(plan.metas):
            if p[0] == "stored":
                if len(p[1]) == isize and checksum.crc32(p[1], device=dev) == crc:
                    results[i] = p[1]
                else:
                    reasons.append("member length or CRC-32 mismatch")
        if any(r is None for r in results):
            _card_reject(buf, reasons[0])
        return b"".join(results)


def _decode_groups(plan: DecodePlan, dev: torch.device, expand: str, results: list) -> list:
    """Decode ``plan``'s members group by group into ``results`` (None
    for a member the card rejects); returns the rejects' reasons."""
    reasons = []
    for lo, hi in _groups(plan):
        outs, reason = _decode_group(plan, lo, hi, dev, expand)
        for i, out in zip(plan.huff[lo:hi], outs):
            results[i] = out
        if reason:
            reasons.append(reason)
    return reasons


def _decode_group(plan: DecodePlan, lo: int, hi: int, dev: torch.device,
                  expand: str) -> tuple:
    """Decode members ``plan.huff[lo:hi]`` in one launch and expand them by
    ``expand``.  Returns (their bytes, None for a member with a row not
    ok or off its recorded TS count, or whose length or CRC-32 does not
    match; the reason of such rejects, or None)."""
    huff, metas = plan.huff[lo:hi], plan.metas
    st = inflate_cu.stage([metas[i][1] for i in huff], [metas[i][0][1] for i in huff],
                          [metas[i][0][2] for i in huff], plan.rows[lo:hi], dev)
    cmds, ok, ncmds = inflate_cu.decode(st["words"], st["tabs"], st["row_ptr"],
                                        st["start"], st["stop"], st["nbits"],
                                        st["blocks"], plan.max_cmds(lo, hi))
    want = transfer.upload(np.array([c for r in plan.counts[lo:hi] for c in r], np.int32), dev)
    counts = torch.diff(st["row_ptr"].to(torch.int64))
    good = ok & torch.repeat_interleave(st["tab_ok"], counts, output_size=ok.shape[0]) \
        & ((want < 0) | (ncmds == want))
    rejected = not bool(transfer.read_now(good.all()))
    # each member's rows are consecutive: its command stream is the
    # concatenation of its rows' spans; a rejected row's are dropped
    spans = torch.where(good, inflate.slot_counts_bits(cmds >> 26, st["stop"]), 0)
    row_starts = torch.cat([spans.new_zeros(1), torch.cumsum(spans, 0)])
    total = int(transfer.read_now(row_starts[-1]))
    flat = inflate.compact_commands(cmds, spans, lz77._ceil_pow2(total))
    bounds = row_starts[st["row_ptr"].to(torch.int64)]
    isizes = [metas[i][3] for i in huff]
    crcs = [metas[i][2] for i in huff]
    if expand != "device":
        outs = _expand_native(flat[:total], bounds, isizes, crcs)
    else:
        outs = _expand_device(flat, bounds, isizes, crcs)
    if rejected:
        member = np.repeat(np.arange(len(huff)), [len(r) for r in plan.rows[lo:hi]])
        for k in set(member[~transfer.read_now(good)].tolist()):
            outs[k] = None
        return outs, "card decode rejected a row"
    return outs, None if all(o is not None for o in outs) else "member length or CRC-32 mismatch"


@profiling.spanned("decode.expand", cpu=True)
def _expand_native(flat: torch.Tensor, bounds: torch.Tensor, isizes: list,
                   crcs: list) -> list:
    """The host route: the compacted commands fetched once, each member's
    span ``flat[bounds[k]:bounds[k + 1]]`` expanded by the native library
    and checked by length and CRC-32; None for a member that fails."""
    flat = transfer.read_now(flat).astype(np.uint32)
    bounds = transfer.read_now(bounds)
    out = []
    for k, (isize, crc) in enumerate(zip(isizes, crcs)):
        span = np.ascontiguousarray(flat[bounds[k]:bounds[k + 1]])
        # a command gives at most MAX_MATCH bytes: an overstated isize
        # sizes no larger buffer
        buf = np.empty(min(isize, lz77.MAX_MATCH * span.size) + 4, np.uint8)
        try:
            produced = native.expand_cmds(span, buf)
        except ValueError:
            produced = -1
        good = produced == isize and native.crc32(buf[:isize]) == crc
        out.append(buf[:isize].tobytes() if good else None)
    return out


@profiling.spanned("decode.expand", cpu=True)
def _expand_device(flat: torch.Tensor, bounds: torch.Tensor, isizes: list,
                   crcs: list) -> list:
    """The device route: the members' command streams regrouped into one
    row each, expanded and CRC-checked on their device; None for a member
    whose length or CRC-32 does not match."""
    dev = flat.device
    mstart, mtotal = bounds[:-1], torch.diff(bounds)
    mc = lz77._ceil_pow2(int(transfer.read_now(mtotal.max())))
    j = torch.arange(mc, device=dev)[None, :]
    idx = torch.clamp(mstart[:, None] + j, max=flat.shape[0] - 1)
    mem = torch.where(j < mtotal[:, None], flat[idx], inflate.END)
    # a command gives at most MAX_MATCH bytes: an overstated isize sizes
    # no wider rows
    width = lz77._ceil_pow2(min(max(isizes), lz77.MAX_MATCH * mc))
    payload, lengths = inflate.expand_commands(mem >> 26, mem & 0x3FF, (mem >> 10) & 0xFFFF,
                                               width)
    got = checksum.crc32_batch_device(payload, lengths)
    lengths = transfer.read_now(lengths)
    payload = transfer.read_now(payload)
    return [payload[k, :isize].tobytes() if int(lengths[k]) == isize and int(got[k]) == crc
            else None for k, (isize, crc) in enumerate(zip(isizes, crcs))]


# ---------------------------------------------------------------------------
# The fixed-Huffman device step over a mesh.
# ---------------------------------------------------------------------------


def compress_step_sharded(mesh, data, n_valid, hist_len, bfinal, *, level: int = 6,
                          seg_len: int = 4096):
    """One compression step over ``mesh``: the batch (arrays or tensors,
    data uint8[B, HIST + seg_len], the rest int32[B]) split evenly over
    the mesh's devices (B must divide, as a ``shard_map`` requires), each
    device running ``pipeline.fixed_deflate_segments`` on its rows.

    Returns (words uint32[B, out_words], sizes_all int32[ndev, B],
    total_bits int32[]) on the first device, in the reference's layout:
    ``sizes_all`` is its all-gathered totals under ``P(None, "dp")``, so
    ``sizes_all[r, k * B / ndev + j]`` is the total bits of device r's
    j-th row for every k; ``total_bits`` is the sum of all rows.  The
    devices' steps are dispatched one after another from this thread, so
    a larger mesh is no faster."""
    devs = _mesh_devices(mesh, None)
    nd = len(devs)
    b = data.shape[0]
    if b % nd:
        raise ValueError(f"a batch of {b} rows does not split over {nd} devices")
    per = b // nd
    words, totals = [], []
    for k, dev in enumerate(devs):
        rows = slice(k * per, (k + 1) * per)
        w, t = pipeline.fixed_deflate_segments(
            *(torch.as_tensor(x[rows]).to(dev) for x in (data, n_valid, hist_len, bfinal)),
            level=level, seg_len=seg_len)
        words.append(w)
        totals.append(t)
    home = devs[0]
    gathered = torch.stack([t.to(home) for t in totals])  # [ndev, per]
    total_bits = gathered.sum(dtype=torch.int32)
    # concatenated as int32 views: uint32 tensors support few operations
    words = torch.cat([w.to(home).view(torch.int32) for w in words]).view(torch.uint32)
    return words, gathered.repeat(1, nd), total_bits
