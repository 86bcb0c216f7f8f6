"""The member-parallel gzip archive on the card: indexed write and decode.

Counterpart of ``decompress_tpu/parallel/sharded.py`` on one device.

* :func:`sharded_gzip_compress` splits the input into independent
  members of ``member_size`` bytes (gzip allows concatenated members),
  compresses them in batches of ``de.MAX_DEVICE_BATCH`` with no history
  (members reset the window), records in each packed member the split
  points of its symbol stream (every ``SPLIT_BITS`` bits), and writes
  member sizes and splits into a standard FEXTRA index in the first
  member's header (the TZ subfield, plus the compact TB subfield: one
  byte per split).  Member CRC-32s are computed on the card.  The bytes
  equal the reference's; any gzip reader decodes them.
* :func:`sharded_gzip_decompress` decodes such an archive on the card:
  every split row of every member at once (``ops/inflate_cu.decode``),
  then the rows' commands are concatenated per member, expanded to bytes
  and checked against each member's CRC-32, all on the card.

Archives the card path does not cover, as the host reads them from the
index and the block headers before anything goes to the card (no index,
the legacy command-stride TS index, multi-block members or trees too
deep for the decode tables), take a serial route through the standard
library's ``zlib``.  Each use adds one to ``serial_fallbacks[reason]``,
so a fallback is always visible; the port's own archives never take it.
Once the card has decoded, a rejected row or a member whose CRC-32 or
length does not match raises ``de.MalformedError``: the card's result
is never replaced by a host decode.  The reference's multi-device
``mesh`` and ``config`` arguments and its ``expand`` choice (native host
or device expansion) are not ported.
"""

from __future__ import annotations

import collections
import zlib

import numpy as np
import torch

from .. import de, gz
from ..core import bitstream, huffman
from ..ops import checksum, inflate, inflate_cu, lz77

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

#: serial-route uses by reason; stays empty for the port's own archives
serial_fallbacks: collections.Counter = collections.Counter()


def _batched_members(arr: np.ndarray, member_size: int, hist: int):
    n = arr.size
    m = max(1, (n + member_size - 1) // member_size)
    data = np.zeros((m, hist + member_size), dtype=np.uint8)
    n_valid = np.zeros(m, dtype=np.int32)
    for i in range(m):
        lo = i * member_size
        hi = min(lo + member_size, n)
        n_valid[i] = hi - lo
        data[i, hist : hist + hi - lo] = arr[lo:hi]
    return data, n_valid


def _compress_members(arr, level, member_size, dev, shared_tree=False):
    """Member compression on ``dev``, in chunks of MAX_DEVICE_BATCH
    members (a tail chunk padded as ``de._batch_rows`` pads it); every
    member is a final block.

    Returns (parts, n_valid, crcs) where parts[i] is either ("stored",
    payload_u8) or ("packed", packed_u8, total_bits, splits, ncmds),
    splits being the N_SPLITS-1 (bit_off, cmd_idx, out_off) triples
    (bit_off 0 = none).  ``shared_tree`` analyzes every chunk first, sums
    the histograms, builds one dynamic tree and packs every member with
    it."""
    # members are independent (window reset at boundaries), so they run
    # with no history prefix
    hist = 0
    data, n_valid = _batched_members(arr, member_size, hist)
    m = data.shape[0]
    chunk = de.MAX_DEVICE_BATCH
    out_words = (9 * member_size) // 32 + 2 * de._HDR_PAD

    def analyze(lo):
        hi = min(lo + chunk, m)
        b = hi - lo
        b_pad = de._batch_rows(b)
        cdata = np.zeros((b_pad, data.shape[1]), dtype=np.uint8)
        cdata[:b] = data[lo:hi]
        cnv = np.zeros(b_pad, np.int32)
        cnv[:b] = n_valid[lo:hi]
        d_data = torch.from_numpy(cdata).to(dev)
        d_nv = torch.from_numpy(cnv).to(dev)
        d_hl = torch.zeros(b_pad, dtype=torch.int32, device=dev)
        res = lz77.lz77_analyze(d_data, d_nv, d_hl, level=level,
                                seg_len=member_size, hist=hist)
        res = lz77.analyze2_finish(res, d_data, d_nv, d_hl, level=level,
                                   seg_len=member_size, hist=hist)
        hist_lit = res["hist_lit"].cpu().numpy()[:b]
        hist_dist = res["hist_dist"].cpu().numpy()[:b]
        return b, b_pad, cdata, cnv, d_data, res, hist_lit, hist_dist

    def pack(st, shared):
        b, b_pad, cdata, cnv, d_data, res, hist_lit, hist_dist = st
        (hdr_vals, hdr_bits), tabs, kinds = de.plan_blocks(
            hist_lit, hist_dist, cnv[:b], np.ones(b, bool), pad_to=b_pad,
            shared_tree=shared or False)
        pk = de.pack_segments(res, d_data[:, hist:], hdr_vals, hdr_bits, *tabs,
                              out_words=out_words, n_splits=N_SPLITS,
                              split_stride=SPLIT_STRIDE, split_bits=SPLIT_BITS)
        return b, cdata, cnv, d_data, kinds, pk

    if shared_tree:
        staged = [analyze(lo) for lo in range(0, m, chunk)]
        hl_sum = np.zeros(de.NUM_LIT_SYMS, np.int64)
        hd_sum = np.zeros(de.NUM_DIST_SYMS, np.int64)
        for *_, hist_lit, hist_dist in staged:
            hl_sum[: hist_lit.shape[1]] += hist_lit.astype(np.int64).sum(axis=0)
            hd_sum[: hist_dist.shape[1]] += hist_dist.astype(np.int64).sum(axis=0)
        hl_sum[de.EOB] += m  # one EOB per member block
        s_lit = huffman.code_lengths_from_frequencies(hl_sum)
        s_dist = huffman.code_lengths_from_frequencies(hd_sum)
        shared = (s_lit, s_dist, de.build_dynamic_header(s_lit, s_dist))
        packed_iter = (pack(st, shared) for st in staged)
    else:
        packed_iter = (pack(analyze(lo), None) for lo in range(0, m, chunk))

    parts: list = []
    crcs_all: list = []
    for b, cdata, cnv, d_data, kinds, pk in packed_iter:
        (words, totals), (sp_bits, sp_cmds, sp_outs, sp_n) = pk
        totals = totals.cpu().numpy()[:b]
        sp_bits, sp_cmds, sp_outs, sp_n = (
            a.cpu().numpy()[:b] for a in (sp_bits, sp_cmds, sp_outs, sp_n))
        used = [int(totals[i]) for i in range(b) if kinds[i] != "stored"]
        cap = (max(used) + 31) // 32 + 1 if used else 0
        words = words[:b, :cap].cpu().numpy().astype("<u4")
        crcs_all.extend(checksum.crc32_batch_device(d_data[:, hist:], cnv)[:b])
        for i in range(b):
            if kinds[i] == "stored":
                parts.append(("stored", cdata[i, hist : hist + cnv[i]]))
            else:
                splits = [
                    (int(sp_bits[i, j]), int(sp_cmds[i, j]), int(sp_outs[i, j]))
                    for j in range(N_SPLITS - 1)
                ]
                parts.append(("packed", words[i].view(np.uint8), int(totals[i]),
                              splits, int(sp_n[i])))
    return parts, n_valid, np.array(crcs_all)


def _encode_tb(split_rows: list, ncmds: list, stride: int) -> bytes | None:
    """Compact TB payload, or None when any split point doesn't fit the
    delta encoding (e.g. command-stride archives)."""
    out = [int(stride).to_bytes(4, "little")]
    for row, total in zip(split_rows, ncmds):
        valid = [t for t in row if t[0] > 0]
        deltas = []
        maxc = 0
        prev_ci = 0
        for j, (bo, ci, _oo) in enumerate(valid, start=1):
            d = j * stride - bo
            if not 0 <= d <= 255:
                return None
            deltas.append(d)
            maxc = max(maxc, ci - prev_ci)
            prev_ci = ci
        if valid and total:
            maxc = max(maxc, int(total) - prev_ci)
        elif not valid:
            maxc = min(int(total), 65535) if total else 0
        out.append(len(deltas).to_bytes(2, "little")
                   + min(maxc, 65535).to_bytes(2, "little")
                   + bytes(deltas))
    return b"".join(out)


def sharded_gzip_compress(data, level: int = 6, *, member_size: int = de.SEGMENT_SIZE,
                          mtime: int = 0, os: int = gz.OS_UNIX, index: bool = True,
                          shared_tree: bool = False, device="cuda") -> bytes:
    """Multi-member gzip archive, members compressed in parallel on
    ``device``; byte-identical to the reference's
    ``sharded_gzip_compress`` with the same arguments.  With ``index``
    (the default) the first member's FEXTRA lists the member sizes and
    split points so :func:`sharded_gzip_decompress` can decode all
    members in parallel; other gzip readers ignore it."""
    dev = de._resolve_device(device)
    arr = de._np_u8(data)
    if arr.size == 0:
        return gz.compress(b"", level, device=device)
    parts, n_valid, crcs = _compress_members(arr, level, member_size, dev,
                                             shared_tree=shared_tree)
    m = len(parts)

    head = b"\x1f\x8b\x08\x00" + (mtime & 0xFFFFFFFF).to_bytes(4, "little") \
        + bytes([gz._xfl(level), int(os)])
    bodies = []
    for part in parts:
        w = bitstream.BitWriter()
        if part[0] == "stored":
            de._emit_stored(w, part[1], final=True)
        else:
            w.write_packed(part[1], part[2])
        bodies.append(w.getvalue())

    sizes = [len(head) + len(b) + 8 for b in bodies]
    split_rows = [
        part[3] if part[0] == "packed" else [(0, 0, 0)] * (N_SPLITS - 1)
        for part in parts
    ]
    ncmds = [part[4] if part[0] == "packed" else 0 for part in parts]
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
        out.append(int(crcs[i]).to_bytes(4, "little"))
        out.append(int(int(n_valid[i]) & 0xFFFFFFFF).to_bytes(4, "little"))
    return b"".join(out)


def _build_index(m: int, sizes: list, split_rows: list,
                 ncmds: list | None = None) -> bytes | None:
    """FEXTRA bytes (XLEN + subfields) for the member index, or None.

    ``sizes`` are per-member byte sizes excluding the index field itself
    (the first member's recorded size grows by the field's length);
    ``split_rows`` holds N_SPLITS - 1 (bit, cmd, out) triples per member
    (all-zero for stored members).  With bit-stride splits and ``ncmds``
    the splits go into the compact TB subfield: u32 stride, then per
    member a u16 count, a u16 maximum of commands per row and count u8
    deltas; otherwise into the legacy TS subfield of 12-byte triples.
    """
    if m > (65531 - 8) // 4:
        return None
    tb = None
    if SPLIT_BITS > 0 and ncmds is not None:
        tb = _encode_tb(split_rows, ncmds, SPLIT_BITS)
    xdata_len = 4 + 4 * m
    extra_len = 2 + 4 + xdata_len
    sfield = b""
    if tb is not None and 4 + xdata_len + 4 + len(tb) <= 65535:
        sfield = TBITS_ID + len(tb).to_bytes(2, "little") + tb
        extra_len += len(sfield)
        use_splits = False
    else:
        # legacy 12-byte triples, one global subfield
        split_len = 1 + sum(
            1 + 12 * sum(1 for t in row if t[0] > 0) for row in split_rows)
        use_splits = 4 + (4 + 4 * m) + (4 + split_len) <= 65535
    if use_splits:
        # count-prefixed valid triples per member (bit offset 0 = unused)
        parts_enc = []
        for row in split_rows:
            valid = [t for t in row if t[0] > 0]
            parts_enc.append(bytes([len(valid)]) + b"".join(
                bo.to_bytes(4, "little") + ci.to_bytes(4, "little")
                + oo.to_bytes(4, "little") for (bo, ci, oo) in valid))
        sdata = bytes([N_SPLITS]) + b"".join(parts_enc)
        sfield = SPLIT_ID + len(sdata).to_bytes(2, "little") + sdata
        extra_len += len(sfield)
    sizes = list(sizes)
    sizes[0] += extra_len  # first member grows by the FEXTRA
    xfield = INDEX_ID + xdata_len.to_bytes(2, "little") \
        + m.to_bytes(4, "little") \
        + b"".join(s.to_bytes(4, "little") for s in sizes) + sfield
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


def _serial(buf: np.ndarray, reason: str) -> bytes:
    """Serial decode of concatenated gzip members with the standard
    library's zlib; counts the use under ``reason``."""
    serial_fallbacks[reason] += 1
    data = buf.tobytes()
    out = []
    while data:
        d = zlib.decompressobj(31)
        out.append(d.decompress(data))
        if not d.eof:
            raise zlib.error("incomplete gzip member")
        data = d.unused_data
    return b"".join(out)


def decode_plan(buf: np.ndarray):
    """Host half of the decode: parse the index and every member's block
    header.  Returns (metas, huff, rows, max_cmds): ``metas[i]`` =
    (prepared member, body, crc, isize); ``huff`` the members decoded on
    the card; ``rows[k]`` the (start, stop) bits of the k-th of them's
    split rows (stop 0 = to end-of-block); ``max_cmds`` the command
    capacity of a row.  Raises _Serial for what the card path does not
    cover, and for split bits outside a member's body."""
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
        return metas, huff, [], 0
    if tb is None or splits is None or len(splits) != len(metas):
        raise _Serial("no bit-stride split index")
    rows = []
    for i in huff:
        start = metas[i][0][3]
        bits = [start] + [t[0] for t in splits[i] if t[0] > 0]
        if any(b <= a for a, b in zip(bits, bits[1:])) or bits[-1] >= metas[i][1].size * 8:
            raise _Serial("corrupt split index")
        rows.append(list(zip(bits, bits[1:] + [0])))
    max_cmds = max(tb["max_cmds"][i] for i in huff) + 4
    return metas, huff, rows, max_cmds


def sharded_gzip_decompress(archive, *, device="cuda") -> bytes:
    """Member-parallel decode of an indexed archive on ``device``; stored
    members resolve on the host, and every member expands on ``device``.

    Archives the device path does not cover, as :func:`decode_plan`
    finds before anything is staged, take the serial zlib route, counted
    in ``serial_fallbacks``; malformed input there raises ``zlib.error``.
    A row the decode rejects, or a member whose CRC-32 or length does not
    match, raises ``de.MalformedError``.  Where the reference falls back
    to a serial decode on those, the port does not."""
    dev = de._resolve_device(device)
    buf = de._np_u8(archive)
    try:
        return _decode_on_device(buf, dev)
    except _Serial as e:
        return _serial(buf, str(e))


def _decode_on_device(buf: np.ndarray, dev: torch.device) -> bytes:
    metas, huff, rows, max_cmds = decode_plan(buf)
    results: list = [None] * len(metas)
    if huff:
        st = inflate_cu.stage([metas[i][1] for i in huff],
                              [metas[i][0][1] for i in huff],
                              [metas[i][0][2] for i in huff], rows, dev)
        cmds, ok, _ = inflate_cu.decode(st["words"], st["tabs"], st["row_ptr"],
                                        st["start"], st["stop"], st["nbits"],
                                        st["blocks"], max_cmds)
        counts = torch.diff(st["row_ptr"].to(torch.int64))
        if not bool((ok & torch.repeat_interleave(st["tab_ok"], counts)).all()):
            raise de.MalformedError("invalid stream")
        # each member's rows are consecutive: its command stream is the
        # concatenation of its rows' spans
        ncmds = inflate.slot_counts_bits(cmds >> 26, st["stop"])
        row_starts = torch.cat([ncmds.new_zeros(1), torch.cumsum(ncmds, 0)])
        flat = inflate.compact_commands(cmds, ncmds, lz77._ceil_pow2(int(row_starts[-1])))
        bounds = row_starts[st["row_ptr"].to(torch.int64)]
        mstart, mtotal = bounds[:-1], torch.diff(bounds)
        mc = lz77._ceil_pow2(int(mtotal.max()))
        j = torch.arange(mc, device=dev)[None, :]
        idx = torch.clamp(mstart[:, None] + j, max=flat.shape[0] - 1)
        mem = torch.where(j < mtotal[:, None], flat[idx], inflate.END)
        out_len = lz77._ceil_pow2(max(metas[i][3] for i in huff))
        payload, lengths = inflate.expand_commands(
            mem >> 26, mem & 0x3FF, (mem >> 10) & 0xFFFF, out_len)
        lengths = lengths.cpu().numpy()
        crcs = checksum.crc32_batch_device(payload, lengths)
        payload = payload.cpu().numpy()
        for k, i in enumerate(huff):
            _, _, crc, isize = metas[i]
            if int(lengths[k]) != isize or int(crcs[k]) != crc:
                raise de.MalformedError("member length or CRC-32 mismatch")
            results[i] = payload[k, :isize].tobytes()
    for i, (p, _, crc, isize) in enumerate(metas):
        if p[0] == "stored":
            if len(p[1]) != isize or checksum.crc32(p[1], device=dev) != crc:
                raise de.MalformedError("member length or CRC-32 mismatch")
            results[i] = p[1]
    return b"".join(results)
