"""Round A's candidate search on the card: the probe record of every
position, the rank-space probe of the sorted hash buckets, then the
winner's exact extension.

The reference runs this part of ``decompress_tpu/ops/lz77.py:
_match_candidates`` as XLA inside the ``jax.jit`` of ``lz77_analyze``:
the words and the fingerprint pyramid (``lz77.py:174``, ``:206``), the
probe fields and the sort key (``:283-330``), the run lengths
(``:515``), its ``probe_step`` (``lz77.py:354``), a ``lax.scan`` over the
K previous sorted ranks, then the packed-winner scatter, the ``descend``
of the winner (``lz77.py:570``) or its exact linear extension, and the
runs, hash3 and clamp merges.  On the TPU each is part of one compiled
program; as eager torch the record build was ~200 launches and the scan
~150 launches per k over ``[B, T]`` int64 arrays.  Here it is three
kernels of ``csrc/probe.cu``:

* :func:`fields`: one block per tile of positions of a row stages the
  tile's bytes with their halo (indices mod T) in shared memory and
  builds, in uint32, the words, the fingerprint pyramid, the probe
  records, the unsorted sort keys, the span walk's fingerprints and the
  capped run lengths, each written once.
* :func:`probe`: one block per tile of ranks of a row stages the ranks'
  positions, hashes and probe records (the tile and the K ranks before
  it) in shared memory, then each thread walks its rank's K
  predecessors there, grades each candidate on the ladder, keeps the
  best (and at ``top2`` the runner-up) and writes the packed winner
  word to its position.  The K predecessors of a rank are the previous
  ranks of its own hash bucket, so a thread stops at the first one of
  another bucket, past ``max_dist`` or before ``valid_lo``: none of
  those can win.
* :func:`extend`: one thread per payload position unpacks the winner
  and resolves its length from the ladder floor (``"rec"``: 16 words,
  plus the runner-up at ``top2``; ``"span"``: the fingerprint span walk
  and the 0..3-byte refine; ``"exact"``: the linear extension), then
  merges the small-distance runs and the hash3 candidate and clamps.

The plain versions are round A's torch code as it was, moved here
unchanged but for their arguments: :func:`fields_plain` (the words,
fingerprints, probe fields, their stack and the key, and the run
lengths), :func:`probe_plain` (the K loop, :func:`_pack_winner` and the
scatter to position space) and :func:`extend_plain`.  The sort of the
keys and hash3's candidates (its own sort) stay torch in
``lz77._match_candidates``.  uint32 arithmetic (hashes, fingerprints)
runs there in int64 masked to 32 bits: torch has no wrapping uint32
multiply, and int32 shifts are arithmetic.

Sort key and probe record.  The ladder has R probe fields a position (R
= 4 on the short ladder, 9 on the full one); the first is the word w.
The key ``hash15 << (pos_bits + KEY_LOW) | pos << KEY_LOW | m & (2^KEY_LOW
- 1)``, with m = w * HASH_MUL mod 2^32 (hash15 is m's top bits), sorts as
``(hash15, pos)`` does, since positions are unique, and carries all of m:
w = m * HASH_MUL_INV.  So the record (int32, uint32 values) holds the
other R - 1 fields, padded with a zero to :data:`RECORD_STRIDE` 4 words
on the short ladder and exactly 8 (32 bytes, one sector of device
memory) on the full one: the probe kernel's random gather of a record
costs one sector, where the 9 fields took two.

Packed winner word (int64): ``cand << 12 | floor << 3 | tier << 1 |
has``; ``floor`` is the ladder grade (a length floor, at most 224),
``tier`` 2 for a candidate whose first word matched, else 1.
"""

from __future__ import annotations

import torch

from ..core.tables import MAX_MATCH, MIN_MATCH

from .. import _build

#: don't take length-3 matches farther than this (``kTooFar`` in
#: csrc/probe.cu; a copy of ``lz77.TOO_FAR``, which imports this module;
#: tests/test_torch_probe.py holds both equal to the reference's)
TOO_FAR = 4096
# Copies of the reference's byte-deciding hash constants (``kHashBits``,
# ``kHashMul``, ``kPremixMul``, ``kMixRot`` in csrc/probe.cu);
# tests/test_torch_lz77.py holds them equal.
HASH_BITS = 15
#: hash / fingerprint multiplier (Knuth's golden-ratio constant)
HASH_MUL = 2654435761
#: fingerprint premix multiplier applied to the raw words first
PREMIX_MUL = 2246822519
#: rotate-left amount of the fingerprint combine
MIX_ROT = 13
#: fingerprint span lengths (powers of two up to MAX_MATCH)
_FP_SPANS = (4, 8, 16, 32, 64, 128, 256)
#: the span walk's fingerprints, in the order extend takes them
SPAN_FPS = (128, 64, 32, 16, 8)
#: the "no candidate" score
NEG_INF = -(1 << 30)
#: the packed word of a position with no winner (tier 1, nothing else)
NO_WINNER = 1 << 1
#: positions per block of the fields kernel (``kFieldsTile``)
FIELDS_TILE = 1024
#: ranks per block of the probe kernel (``kTile`` in csrc/probe.cu)
TILE = 256
#: most predecessors the probe kernel takes (its shared memory holds the
#: tile and the K ranks before it)
MAX_K = 512
#: resolution of the winner's length: by level config
MODES = ("exact", "rec", "span")
#: probe fields per ladder: short (levels 1-4), full (levels 5-12)
RECORD_WIDTH = {False: 4, True: 9}
#: int32 words a record takes: fields 1..R-1, the short ladder's padded to 4
RECORD_STRIDE = {False: 4, True: 8}
#: bits of m = w * HASH_MUL below the position in the probe's sort key
#: (``kKeyLow`` in csrc/probe.cu): m's bits under hash15
KEY_LOW = 32 - HASH_BITS
#: the inverse of HASH_MUL mod 2^32: w = m * HASH_MUL_INV
HASH_MUL_INV = pow(HASH_MUL, -1, 1 << 32)
_M32 = 0xFFFFFFFF


def key_bits(t: int) -> int:
    """Bits a row's positions take in its sort keys (``pos_bits``)."""
    return max(1, (t - 1).bit_length())


def key_parts(skey, pos_bits: int):
    """(pos, hash15, w) of the probe's sort keys (see the module docstring)."""
    low = skey & ((1 << KEY_LOW) - 1)
    h = skey >> (pos_bits + KEY_LOW)
    return ((skey >> KEY_LOW) & ((1 << pos_bits) - 1), h,
            _mul32((h << KEY_LOW) | low, HASH_MUL_INV))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) without int64 overflow:
    only the low 16 bits of x * (c >> 16) survive the shift by 16."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _u32_words(b: torch.Tensor) -> torch.Tensor:
    """4-byte little-endian word at every position of uint8[B, T], as
    int64 (wraps at the row end; validity clamps mask the wrap)."""
    x = b.to(torch.int64)
    return (x | (torch.roll(x, -1, 1) << 8) | (torch.roll(x, -2, 1) << 16)
            | (torch.roll(x, -3, 1) << 24))


def _mix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Combine two span fingerprints: (a ^ rotl13(b)) * HASH_MUL."""
    rot = ((b << MIX_ROT) & _M32) | (b >> (32 - MIX_ROT))
    return _mul32(a ^ rot, HASH_MUL)


def _fingerprints(w: torch.Tensor) -> dict[int, torch.Tensor]:
    """F[L][:, i] = fingerprint of bytes [i, i+L); F[4] is the exact word.
    The doubling chain starts from a premultiplied copy of the word."""
    fp = {4: w}
    cur = _mul32(w, PREMIX_MUL)
    for span in _FP_SPANS[1:]:
        cur = _mix(cur, torch.roll(cur, -(span // 2), 1))
        fp[span] = cur
    return fp


def _hash15(w: torch.Tensor) -> torch.Tensor:
    """The HASH_BITS-bit bucket hash of a (masked) word."""
    return _mul32(w, HASH_MUL) >> (32 - HASH_BITS)


def _h16(x: torch.Tensor) -> torch.Tensor:
    """16-bit hash of a uint32 value (the full ladder's probe halves)."""
    return _mul32(x, HASH_MUL) >> 16


def _pack2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two 16-bit hashes in one uint32 value: h16(a) high, h16(b) low."""
    return (_h16(a) << 16) | _h16(b)


def _probe_fields(w, fp, full_ladder: bool) -> tuple[torch.Tensor, ...]:
    """The ladder's probe fields at every position.  Short ladder: the
    exact words at +0 and +4, the 16- and 64-byte fingerprints.  Full
    ladder: the exact words and the 16-byte fingerprint, then six packed
    16-bit hash pairs (offset fingerprints between the power-of-two
    spans; the hi half of the last covers bytes [192, 224))."""
    def ahead(a, k):
        return torch.roll(a, -k, 1)

    if not full_ladder:
        return w, ahead(w, 4), fp[16], fp[64]
    return (w, ahead(w, 4), fp[16],
            _pack2(ahead(w, 6), ahead(fp[8], 4)),
            _pack2(ahead(w, 10), ahead(w, 16)),
            _pack2(ahead(fp[16], 8), fp[32]),
            _pack2(ahead(fp[16], 32), fp[64]),
            _pack2(ahead(fp[32], 64), fp[128]),
            _pack2(ahead(fp[32], 192), ahead(fp[64], 128)))


def _suffix_min(x: torch.Tensor) -> torch.Tensor:
    """Reverse cumulative minimum along the last axis."""
    return torch.flip(torch.cummin(torch.flip(x, (-1,)), -1).values, (-1,))


def _run_lengths(eq: torch.Tensor) -> torch.Tensor:
    """out[..., i] = length of the run of True starting at i (int32)."""
    n = eq.shape[-1]
    idx = torch.arange(n, device=eq.device)
    return (_suffix_min(torch.where(eq, n, idx)) - idx).to(torch.int32)


def fields_plain(data, *, hist: int, full_ladder: bool, spans: bool, runs: bool):
    """(w, key, rec, span fingerprints or None, runs or None) of a batch;
    see :func:`fields`."""
    t = data.shape[1]
    w = _u32_words(data)
    fp = _fingerprints(w)
    m = _mul32(w, HASH_MUL)
    key = (((m >> KEY_LOW) << (key_bits(t) + KEY_LOW))
           | (torch.arange(t, device=data.device) << KEY_LOW) | (m & ((1 << KEY_LOW) - 1)))
    rec = torch.stack(_probe_fields(w, fp, full_ladder)[1:], 2).to(torch.int32)
    rec = torch.nn.functional.pad(rec, (0, RECORD_STRIDE[full_ladder] - rec.shape[2]))
    span_fps = tuple(fp[span] for span in SPAN_FPS) if spans else None
    run = None
    if runs:
        # exact small-distance (RLE-ish) run lengths, payload only
        eqs = torch.stack(
            [(data == torch.roll(data, d, 1))[:, hist:] for d in (1, 2, 3, 4)])
        run = torch.clamp(_run_lengths(eqs), max=MAX_MATCH)
    return w, key, rec, span_fps, run


def fields(data, *, hist: int, full_ladder: bool, spans: bool, runs: bool):
    """Everything the probe and the extension read of a batch of segments,
    from its bytes alone -> (w, key, rec, span fingerprints, runs).

    data: uint8[B, T].  w: int64[B, T] the 4-byte little-endian word at
    every position (wrapping at the row end); key: int64[B, T] the
    unsorted sort keys of the probe, which carry the word (see the module
    docstring); rec: int32[B, T, RECORD_STRIDE] the ladder's other probe
    fields of every position; with ``spans``, the int64[B, T]
    fingerprints of spans 128, 64, 32, 16 and 8 (else None);
    with ``runs``, int32[4, B, T - hist] the lengths of the runs of
    data[i] == data[i - d] (index mod T) from every payload position i,
    d = 1..4, stopping at the row end and capped at MAX_MATCH (else
    None).

    A CPU tensor takes :func:`fields_plain`; a CUDA tensor launches the
    kernel (or raises)."""
    kw = dict(hist=hist, full_ladder=full_ladder, spans=spans, runs=runs)
    if data.device.type == "cpu":
        return fields_plain(data, **kw)
    b, t = data.shape
    if not 0 <= hist < t:
        raise ValueError(f"fields: hist={hist} outside [0, T={t})")
    _build.check_cuda("data", data, torch.uint8)
    dev = data.device
    w = torch.empty((b, t), dtype=torch.int64, device=dev)
    key = torch.empty_like(w)
    rec = torch.empty((b, t, RECORD_STRIDE[full_ladder]), dtype=torch.int32, device=dev)
    span_fps = torch.empty((len(SPAN_FPS), b, t), dtype=torch.int64, device=dev) \
        if spans else None
    run = torch.empty((4, b, t - hist), dtype=torch.int32, device=dev) if runs else None
    err = _build.lib().dtt_fields(
        data.data_ptr(), w.data_ptr(), key.data_ptr(), rec.data_ptr(),
        0 if span_fps is None else span_fps.data_ptr(), 0 if run is None else run.data_ptr(),
        b, t, hist, key_bits(t), int(full_ladder), _build.stream(data))
    _build.launched("fields", err)
    return w, key, rec, None if span_fps is None else tuple(span_fps.unbind(0)), run


def _prefix_bytes_equal(x: torch.Tensor) -> torch.Tensor:
    """Number of equal low-order bytes given xor of two words (0..4)."""
    nz = x != 0
    return ((~nz).to(torch.int32) * 4
            + (nz & ((x & 0xFF) == 0)).to(torch.int32)
            + (nz & ((x & 0xFFFF) == 0)).to(torch.int32)
            + (nz & ((x & 0xFFFFFF) == 0)).to(torch.int32))


def _ladder_rungs(xs, full_ladder: bool):
    """(hit, weight) per rung above the 8-byte words, in chain order,
    from the xors of the probe fields after the two exact words: each
    rung counts only if every rung before it hit."""
    if not full_ladder:
        x16, x64 = xs
        return ((x16 == 0, 8), (x64 == 0, 48))
    x16, p1, p2, p3, p4, p5, p6 = xs

    def hi(x):
        return (x & 0xFFFF0000) == 0

    def lo(x):
        return (x & 0xFFFF) == 0

    # floors 10, 12, 14, 16, 20, 24, 32, 48, 64, 96, 128, 192, 224
    return ((hi(p1), 2), (lo(p1), 2), (hi(p2), 2), (x16 == 0, 2),
            (lo(p2), 4), (hi(p3), 4), (lo(p3), 8), (hi(p4), 16),
            (lo(p4), 16), (hi(p5), 32), (lo(p5), 32), (lo(p6), 64),
            (hi(p6), 32))


def _pack_winner(score, cand, p4, sp):
    """A probe winner as one int64 word: cand << 12 | floor << 3 |
    tier << 1 | has.  The grade is recovered from the score
    ((grade << 17) - dist); tier 1 = an exactly-3-byte candidate."""
    has = score > NEG_INF
    grade = torch.clamp((score + (sp - cand)) >> 17, 0, MAX_MATCH)
    return ((torch.clamp(cand, min=0) << 12)
            | (torch.where(has, grade, 0) << 3)
            | (torch.where(p4 >= 4, 2, 1) << 1) | has.to(torch.int64))


def _at_positions(packed_r, sp, hist: int):
    """A rank-space packed word scattered to position space (sp is a
    permutation of each row), payload only."""
    return torch.zeros_like(packed_r).scatter_(1, sp, packed_r)[:, hist:]


def _unpack(packed, pos_pay):
    """(has, tier, floor, cand-safe, dist) of packed winners."""
    has = (packed & 1) == 1
    cand = packed >> 12
    return (has, (packed >> 1) & 3, (packed >> 3) & 0x1FF,
            torch.where(has, cand, 0), pos_pay - cand)


def probe_plain(skey, pos_bits: int, rec, valid_lo, valid_hi, *, hist: int,
                max_dist: int, k: int, full_ladder: bool, top2: bool):
    """The packed winner of every payload position by the K loop in rank
    space; see :func:`probe`."""
    sp, sh, w_s = key_parts(skey, pos_bits)
    t = sp.shape[1]
    fields = rec[:, :, :RECORD_WIDTH[full_ladder] - 1].to(torch.int64) & _M32
    probes = (w_s, *torch.gather(
        fields, 1, sp[:, :, None].expand(-1, -1, fields.shape[2])).unbind(2))
    del fields

    sp_ok = sp < valid_hi
    best_score = torch.full_like(sp, NEG_INF)
    best_cand = torch.zeros_like(sp)
    best_p4 = torch.zeros(sp.shape, dtype=torch.int32, device=sp.device)
    if top2:
        score2, cand2, p42 = (torch.full_like(sp, NEG_INF),
                              torch.zeros_like(sp), torch.zeros_like(best_p4))
    # every probe array padded once with K leading fill values: the k-th
    # previous rank is then a view, not a copy
    def padded(a, fill):
        return torch.cat([a.new_full((a.shape[0], k), fill), a], 1)

    sp_pad, sh_pad = padded(sp, -1), padded(sh, -1)
    probes_pad = [padded(a, 0) for a in probes]
    for kk in range(1, k + 1):
        lo = k - kk  # the kk-th previous rank starts here in a padded row
        cand_p = sp_pad[:, lo:lo + t]
        cand_h = sh_pad[:, lo:lo + t]
        xs = [a_pad[:, lo:lo + t] ^ a for a_pad, a in zip(probes_pad, probes)]
        dist = sp - cand_p
        ok = ((cand_p >= 0) & (cand_h == sh) & (dist <= max_dist)
              & (cand_p >= valid_lo) & (cand_p < valid_hi) & sp_ok)
        plen4 = _prefix_bytes_equal(xs[0])
        len4 = (xs[0] == 0) & ok
        plen8 = torch.where(len4, _prefix_bytes_equal(xs[1]), 0)
        eq = len4 & (xs[1] == 0)
        grade = torch.where(ok, plen4, 0) + plen8
        for hit, weight in _ladder_rungs(xs[2:], full_ladder):
            eq = eq & hit
            grade = grade + torch.where(eq, weight, 0)
        usable = ok & (plen4 >= 3)
        score = torch.where(usable, (grade.to(torch.int64) << 17) - dist,
                            NEG_INF)
        better = score > best_score  # first max wins: argmax parity
        if top2:
            # the runner-up: the old best when a new best arrives,
            # else the new score if it beats the old runner-up
            b2 = ~better & (score > score2)
            score2 = torch.where(better, best_score,
                                 torch.where(b2, score, score2))
            cand2 = torch.where(better, best_cand,
                                torch.where(b2, cand_p, cand2))
            p42 = torch.where(better, best_p4, torch.where(b2, plen4, p42))
        best_score = torch.where(better, score, best_score)
        best_cand = torch.where(better, cand_p, best_cand)
        best_p4 = torch.where(better, plen4, best_p4)
    del probes, probes_pad

    packed = _at_positions(_pack_winner(best_score, best_cand, best_p4, sp),
                           sp, hist)
    if not top2:
        return packed, None
    return packed, _at_positions(_pack_winner(score2, cand2, p42, sp), sp, hist)


def probe(skey, pos_bits: int, rec, valid_lo, valid_hi, *, hist: int,
          max_dist: int, k: int, full_ladder: bool, top2: bool):
    """Best of the K previous ranks of every payload position's sorted
    bucket -> (packed int64[B, T - hist], packed2 or None).

    skey: int64[B, T] the sorted keys of :func:`fields` (see the module
    docstring); rec: int32[B, T, RECORD_STRIDE] the probe records of
    every position from :func:`fields`;
    valid_lo, valid_hi: int64[B, 1].  A candidate k ranks before rank r
    counts if it has r's hash, lies in [valid_lo, valid_hi) within
    ``max_dist`` of r's position (itself below valid_hi) and shares at
    least 3 bytes; its score is ``(grade << 17) - dist``, and the first
    maximum in k order wins.  ``top2`` also keeps the runner-up.  K = 0
    gives no winner anywhere and launches nothing.

    A CPU tensor takes :func:`probe_plain`; a CUDA tensor launches the
    kernel (or raises)."""
    b, t = skey.shape
    if k == 0:
        return torch.full((b, t - hist), NO_WINNER, dtype=torch.int64,
                          device=skey.device), None
    kw = dict(hist=hist, max_dist=max_dist, k=k, full_ladder=full_ladder,
              top2=top2)
    if skey.device.type == "cpu":
        return probe_plain(skey, pos_bits, rec, valid_lo, valid_hi, **kw)
    if not 0 < k <= MAX_K:
        raise ValueError(f"probe: K={k} outside 1..{MAX_K}")
    if not 0 <= hist < t:
        raise ValueError(f"probe: hist={hist} outside [0, T={t})")
    _build.check_cuda("skey", skey, torch.int64)
    _build.check_cuda("rec", rec, torch.int32, (b, t, RECORD_STRIDE[full_ladder]))
    if rec.data_ptr() % 16:
        raise ValueError("probe: rec must start at a 16-byte boundary")
    if pos_bits + KEY_LOW + HASH_BITS > 63:
        raise ValueError(f"probe: pos_bits={pos_bits} leaves the key no room")
    _build.check_cuda("valid_lo", valid_lo, torch.int64, (b, 1))
    _build.check_cuda("valid_hi", valid_hi, torch.int64, (b, 1))
    packed = torch.empty((b, t - hist), dtype=torch.int64, device=skey.device)
    packed2 = torch.empty_like(packed) if top2 else None
    err = _build.lib().dtt_probe(
        skey.data_ptr(), rec.data_ptr(), valid_lo.data_ptr(), valid_hi.data_ptr(),
        packed.data_ptr(), 0 if packed2 is None else packed2.data_ptr(),
        b, t, hist, pos_bits, max_dist, k, RECORD_WIDTH[full_ladder], _build.stream(skey))
    _build.launched("probe", err)
    return packed, packed2


def _rec_descent(w, has, floor, bsafe, pos_pay):
    """Length = floor + the exact common prefix of the 16 words (64
    bytes) at floor past the candidate and past the position: the
    reference's "rec" descent (its record row ``rec64[i, j]`` is the
    word at ``(i + 4j) mod T``)."""
    b, s = has.shape
    t = w.shape[1]
    length = torch.where(has, floor, 0)
    offs = 4 * torch.arange(16, device=w.device)

    def words(start):
        idx = (torch.clamp(start, max=t - 1)[:, :, None] + offs) % t
        return torch.gather(w, 1, idx.reshape(b, s * 16)).reshape(b, s, 16)

    x = words(bsafe + length) ^ words(pos_pay + length)
    # the first unequal word f (16 if none): 4f equal bytes, then the
    # equal low bytes of word f
    miss = x != 0
    first = torch.where(miss.any(2), miss.to(torch.int32).argmax(2), 16)
    x_f = torch.gather(x, 2, torch.clamp(first, max=15)[:, :, None])[:, :, 0]
    lcp = 4 * first + torch.where(first < 16, _prefix_bytes_equal(x_f), 0)
    return torch.where(has, length + lcp, 0)


def extend_plain(w, packed, packed2, spans, runs, cand3, valid_lo, valid_hi,
                 *, hist: int, mode: str):
    """(length int32, dist int32)[B, T - hist] of the packed winners; see
    :func:`extend`."""
    t = w.shape[1]
    pos_pay = torch.arange(hist, t, device=w.device)
    has, btier, bfloor, bsafe, bdist = _unpack(packed, pos_pay)

    def at(a, idx):
        idx = torch.clamp(idx, max=t - 1)
        return torch.gather(a, 1, idx.expand(a.shape[0], idx.shape[-1]))

    if mode == "exact":
        # exact linear extension in 4-byte steps (the fallback)
        length = torch.zeros_like(bsafe)
        alive = has
        for off in range(0, MAX_MATCH + 4, 4):
            eq = _prefix_bytes_equal(at(w, bsafe + off) ^ at(w, pos_pay + off))
            length = length + torch.where(alive, eq, 0)
            alive = alive & (eq == 4)
    elif mode == "rec":
        # exact 64-byte record compare from the ladder floor: the full
        # ladder's inter-rung gaps are <= 63 bytes, so 16 words resolve
        # the whole extension byte-exactly
        length = _rec_descent(w, has, bfloor, bsafe, pos_pay)
        if packed2 is not None:
            # resolve the runner-up exactly too and keep the longer
            # (ties -> nearer)
            has2, _, bfloor2, bsafe2, bdist2 = _unpack(packed2, pos_pay)
            length2 = _rec_descent(w, has2, bfloor2, bsafe2, pos_pay)
            take2 = (length2 > length) | ((length2 == length) & (bdist2 < bdist))
            length = torch.where(take2, length2, length)
            bdist = torch.where(take2, bdist2, bdist)
    else:
        # doubling descent from the ladder floor over the fingerprint
        # pyramid (the short ladder leaves a 64 -> 258 gap: spans from
        # 128), then the exact 0..3-byte refine
        fps = dict(zip((128, 64, 32, 16, 8, 4), (*spans, w)))
        length = torch.where(has, bfloor, 0)
        for span, f in fps.items():
            eq = ((at(f, bsafe + length) == at(f, pos_pay + length)) & has
                  & (length + span <= MAX_MATCH + 4))
            length = length + torch.where(eq, span, 0)
        rem = _prefix_bytes_equal(at(w, bsafe + length) ^ at(w, pos_pay + length))
        length = length + torch.where(has, torch.clamp(rem, max=3), 0)
        # tier-1 candidates matched only 3 bytes
        length = torch.where(has & (btier == 1) & (length < 3), 3, length)
        length = torch.where(has, length, 0)

    if runs is not None:
        for di, d in enumerate((1, 2, 3, 4)):
            src_ok = (pos_pay - d >= valid_lo) & (pos_pay < valid_hi)
            len_d = torch.where(src_ok, torch.clamp(runs[di], max=MAX_MATCH), 0)
            better = (len_d > length) | ((len_d == length) & (d < bdist))
            bdist = torch.where(better, d, bdist)
            length = torch.where(better, len_d, length)

    if cand3 is not None:
        use3 = (length < MIN_MATCH) & (cand3 >= 0)
        length = torch.where(use3, MIN_MATCH, length)
        bdist = torch.where(use3, pos_pay - cand3, bdist)

    # clamp to data end and legality
    length = torch.clamp(length, max=MAX_MATCH)
    length = torch.minimum(length, torch.clamp(valid_hi - pos_pay, min=0))
    too_far = (length == MIN_MATCH) & (bdist > TOO_FAR)
    length = torch.where(too_far, 0, length)
    length = torch.where(length >= MIN_MATCH, length, 0)
    return length.to(torch.int32), bdist.to(torch.int32)


def extend(w, packed, packed2, spans, runs, cand3, valid_lo, valid_hi, *,
           hist: int, mode: str):
    """Best match (length int32, dist int32)[B, T - hist] of every payload
    position from its packed probe winner(s).

    w: int64[B, T] the 4-byte word at every position (wrapping at the
    row end); packed, packed2: int64[B, T - hist] from :func:`probe`
    (packed2 None unless ``mode`` is ``"rec"`` at a top2 level); spans:
    the int64[B, T] fingerprints of spans 128, 64, 32, 16 and 8 for
    ``mode="span"``, else None; runs: int32[4, B, T - hist] run lengths
    of data[i] == data[i - d] for d = 1..4, or None; cand3: int64[B, T -
    hist] hash3 candidates (-1 none), or None; valid_lo, valid_hi: int64[B, 1].

    The winner's length comes from its ladder floor by ``mode``:
    ``"rec"`` adds the common prefix of 16 words (at top2 the runner-up
    too, the longer or, tied, nearer kept), ``"span"`` walks spans 128
    to 4 and refines 0..3 bytes, ``"exact"`` extends in 4-byte steps to
    MAX_MATCH + 4; then the runs merge (longer, or tied, nearer wins),
    hash3 where no match of MIN_MATCH was found, and the clamps to
    MAX_MATCH, the row's valid end, TOO_FAR at length 3 and MIN_MATCH.

    A CPU tensor takes :func:`extend_plain`; a CUDA tensor launches the
    kernel (or raises)."""
    if w.device.type == "cpu":
        return extend_plain(w, packed, packed2, spans, runs, cand3, valid_lo,
                            valid_hi, hist=hist, mode=mode)
    b, t = w.shape
    s = t - hist
    if mode not in MODES:
        raise ValueError(f"extend: mode {mode!r} not in {MODES}")
    if not 0 <= hist < t:
        raise ValueError(f"extend: hist={hist} outside [0, T={t})")
    if (spans is None) != (mode != "span") or (packed2 is not None and mode != "rec"):
        raise ValueError(f"extend: inputs do not fit mode {mode!r}")
    _build.check_cuda("w", w, torch.int64)
    for name, a in (("packed", packed), ("packed2", packed2)):
        if a is not None:
            _build.check_cuda(name, a, torch.int64, (b, s))
    for i, a in enumerate(spans or ()):
        _build.check_cuda(f"spans[{i}]", a, torch.int64, (b, t))
    if runs is not None:
        _build.check_cuda("runs", runs, torch.int32, (4, b, s))
    if cand3 is not None:
        _build.check_cuda("cand3", cand3, torch.int64, (b, s))
    _build.check_cuda("valid_lo", valid_lo, torch.int64, (b, 1))
    _build.check_cuda("valid_hi", valid_hi, torch.int64, (b, 1))
    length = torch.empty((b, s), dtype=torch.int32, device=w.device)
    dist = torch.empty_like(length)

    def ptr(a):
        return 0 if a is None else a.data_ptr()

    span_ptrs = [ptr(a) for a in spans] if spans is not None else [0] * 5
    err = _build.lib().dtt_extend(
        w.data_ptr(), packed.data_ptr(), ptr(packed2), *span_ptrs, ptr(runs),
        ptr(cand3), valid_lo.data_ptr(), valid_hi.data_ptr(), length.data_ptr(),
        dist.data_ptr(), b, t, hist, MODES.index(mode), _build.stream(w))
    _build.launched("extend", err)
    return length, dist
