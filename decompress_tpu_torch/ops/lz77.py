"""Device LZ77 match finder + parallel greedy/lazy and cost-aware parse
(torch).

Counterpart of ``decompress_tpu/ops/lz77.py`` for every level (1-12) and
the ``rle``/``huffman_only`` strategy slots.  The algorithm is the
reference's, array for array, batched over segments instead of vmapped:

* the words, fingerprints, probe records, keys and small-distance run
  lengths of every position, from the bytes alone: the fields kernel of
  ``probe_cu``;
* hash4 of every position, one sort of a packed ``(hash, pos)`` key: a
  position's K most recent same-hash predecessors are its K previous
  sorted rows, probed in rank space with the grade ladder (the short one
  of levels 1-4: exact 4- and 8-byte words, 16- and 64-byte
  fingerprints; the full 13-rung one of levels 5-12, over 16-bit hash
  pairs), optionally tracking the runner-up (``top2``): the probe kernel
  of ``probe_cu``;
* the winner's length resolved from the ladder floor: by the span-walk
  descent over the fingerprint pyramid plus the exact 0..3-byte refine
  (short ladder), by one exact 64-byte record compare (full ladder), or
  by the exact linear extension (``force_exact``);
* exact small-distance (d <= 4) run candidates merged in, then the
  3-byte-hash pass for pure length-3 matches (``hash3``): with the
  length resolution, the extension kernel of ``probe_cu``;
* greedy/lazy take-defer, the mark-path parse (``parse_cu``), the exact
  verification pass, the histograms (``hist_cu``), and the
  trim-and-reparse repair that makes the output byte-exact;
* for the two-round levels (5-12), round B: host bit-cost tables (one
  native call a batch) and hot-stride mining from round A's histograms,
  then the cost-aware re-parse (literal bits and match gains in
  ``cost_cu``).

uint32 arithmetic (hashes) runs in int64 masked to 32 bits: torch has
no wrapping uint32 multiply, and int32 shifts are arithmetic.

Round A, round B, the trims and the re-parse are programs of
``ops/graphs``, as the reference jits them: on a CUDA device each call
is one replay of a captured CUDA graph.  The host reads between them
(exactness, the cost tables, the retry loops) stay host control flow.
"""

from __future__ import annotations

import collections
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..core import tables
from ..utils import profiling

from . import cost_cu, graphs, hist_cu, parse_cu, probe_cu, transfer
from .probe_cu import _hash15, _run_lengths, _suffix_min, key_bits

# Copies of the reference's byte-deciding constants (ops/lz77.py cannot be
# imported without JAX); tests/test_torch_lz77.py holds them equal.
HIST = 32768          # history prefix per segment (DEFLATE window)
MIN_MATCH = 3
MAX_MATCH = 258
TOO_FAR = 4096        # don't take length-3 matches farther than this
#: exact-distance histogram width for hot-stride mining (round B)
HOT_DIST_BINS = 4096
#: strided-run candidates mined per segment in round B
HOT_DISTS = 8


@dataclass(frozen=True)
class LevelConfig:
    """Per-level tuning (the reference's ``lz77.LevelConfig``)."""

    k_candidates: int   # sorted-bucket candidates (hash-chain depth)
    lazy: bool          # one-step lazy matching
    exact: bool = False  # exact linear extension (fallback / max quality)
    two_round: bool = False  # cost-aware re-parse with round-A code lengths
    full_ladder: bool = True  # 13-probe length-floor grading (speed knob)
    runs: bool = True    # exact small-distance (RLE) candidates
    top2: bool = False   # descend the two best candidates, pick by length
    mine: bool = True    # round-B hot-stride mining (two_round only)
    hash3: bool = False  # 3-byte-hash pass for pure len-3 matches


#: The reference's level table: levels 1-12 and the strategy slots
#: (100 = rle, 101 = huffman-only).
LEVELS: dict[int, LevelConfig] = {
    1: LevelConfig(4, False, full_ladder=False),
    2: LevelConfig(6, False, full_ladder=False),
    3: LevelConfig(8, False, full_ladder=False),
    4: LevelConfig(8, True, full_ladder=False),
    5: LevelConfig(12, True, two_round=True),
    6: LevelConfig(16, True, two_round=True, hash3=True),
    7: LevelConfig(24, True, two_round=True, top2=True, hash3=True),
    8: LevelConfig(32, True, two_round=True, top2=True, hash3=True),
    9: LevelConfig(64, True, two_round=True, top2=True, hash3=True),
    10: LevelConfig(64, True, two_round=True, top2=True, hash3=True),
    11: LevelConfig(96, True, two_round=True, top2=True, hash3=True),
    12: LevelConfig(128, True, two_round=True, top2=True, hash3=True),
    100: LevelConfig(0, False, full_ladder=False),
    101: LevelConfig(0, False, full_ladder=False, runs=False),
}

#: trim-and-reparse attempts before the force_exact re-run
_TRIM_RETRIES = 3


def level_config(level: int) -> LevelConfig:
    """The level's config; unknown levels raise ValueError."""
    if level in LEVELS:
        return LEVELS[level]
    raise ValueError(f"unknown level {level}")


def _ceil_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _shift_right(a: torch.Tensor, k: int, fill: int) -> torch.Tensor:
    """a shifted right by k along axis 1 (the previous-rank neighbour)."""
    return torch.cat([torch.full_like(a[:, :k], fill), a[:, :a.shape[1] - k]],
                     dim=1)


def _sort_key(h: torch.Tensor, t: int) -> tuple[torch.Tensor, int]:
    """(skey, pos_bits): the rows' ``hash << pos_bits | pos`` keys,
    sorted.  One int64 key gives the reference's ``(hash, pos)`` order on
    both of its sort branches, for every segment length."""
    pos_bits = key_bits(t)
    pos = torch.arange(t, device=h.device)
    return torch.sort((h << pos_bits) | pos, dim=1).values, pos_bits


def _match_candidates(data, valid_lo, valid_hi, cfg: LevelConfig,
                      max_dist: int = tables.WINDOW_SIZE, hist: int = HIST):
    """Best match (length int32, dist int32) at every payload position of
    a batch of segments.

    data: uint8[B, T] (T = hist + seg_len); valid data of row b occupies
    [valid_lo[b], valid_hi[b]) (int64[B, 1]).  Lengths from the
    fingerprint descent or the ladder floor may overestimate on a
    collision; callers run the exact verification pass.

    The fields kernel of ``probe_cu`` builds the words, probe records,
    keys, span fingerprints and run lengths from the bytes; the keys'
    sort and the hash3 candidates (their own sort) are torch; the K-rank
    probe and the winner's extension with the merges are the other two
    kernels of ``probe_cu``."""
    t = data.shape[1]
    mode = "exact" if cfg.exact else "rec" if cfg.full_ladder else "span"
    w, key, rec, spans, runs = probe_cu.fields(
        data.contiguous(), hist=hist, full_ladder=cfg.full_ladder, spans=mode == "span",
        runs=cfg.runs)

    # ---- sorted-bucket candidates, probed in rank space: the probe
    # kernel gathers each rank's record of the probe fields ----
    skey = torch.sort(key, dim=1).values
    del key
    top2 = cfg.top2 and not cfg.exact  # the runner-up feeds only "rec"
    packed, packed2 = probe_cu.probe(
        skey, key_bits(t), rec, valid_lo, valid_hi, hist=hist, max_dist=max_dist,
        k=cfg.k_candidates, full_ladder=cfg.full_ladder, top2=top2)
    del skey, rec

    cand3 = None
    if cfg.hash3:
        cand3 = _hash3_candidates(w, valid_lo, valid_hi, max_dist, hist)
    return probe_cu.extend(w, packed, packed2, spans, runs, cand3, valid_lo,
                           valid_hi, hist=hist, mode=mode)


def _hash3_candidates(w, valid_lo, valid_hi, max_dist: int,
                      hist: int) -> torch.Tensor:
    """Pure length-3 match candidates via a 3-byte hash -> int64[B, T -
    hist] over the payload: at each position the nearest of the two
    previous same-hash rows whose low 24 bits equal exactly, within
    min(TOO_FAR, max_dist), or -1 (the match is used only where no other
    was found)."""
    t = w.shape[1]
    w3 = w & 0xFFFFFF
    skey3, pos_bits = _sort_key(_hash15(w3), t)
    sp3, sh3 = skey3 & ((1 << pos_bits) - 1), skey3 >> pos_bits
    w3_s = torch.gather(w3, 1, sp3)
    sp3_ok = sp3 < valid_hi
    best3 = torch.full_like(sp3, -1)
    for k in (1, 2):
        cand_p = _shift_right(sp3, k, -1)
        ok3 = ((cand_p >= 0) & (_shift_right(sh3, k, -1) == sh3)
               & (_shift_right(w3_s, k, 0) == w3_s)
               & (sp3 - cand_p <= min(TOO_FAR, max_dist))
               & (cand_p >= valid_lo) & (cand_p < valid_hi) & sp3_ok)
        best3 = torch.where(ok3 & (best3 < 0), cand_p, best3)
    return torch.full_like(best3, -1).scatter_(1, sp3, best3)[:, hist:].contiguous()


def jump_array(take, plen, seg_len: int, p: int) -> torch.Tensor:
    """The parse's jump array g int32[B, P] over the payload domain:
    g[i] = i + (match length where taken, else 1), capped at P; the tail
    [seg_len, P) steps by one."""
    idx = torch.arange(p, device=take.device)
    g = torch.clamp(idx + 1, max=p).expand(take.shape[0], p).clone()
    step = torch.where(take, plen.to(torch.int64), 1)
    g[:, :seg_len] = torch.clamp(idx[:seg_len] + step, max=p)
    return g.to(torch.int32)


def _mark_batched(take, plen, seg_len: int, p: int) -> torch.Tensor:
    """Jump build + mark path over [B, seg_len] take/step arrays ->
    on_path bool[B, P]."""
    return parse_cu.mark_path(jump_array(take, plen, seg_len, p))


def _take_defer(length, n_valid, seg_len: int, lazy: bool):
    """Greedy or one-step-lazy take decisions over candidate lengths."""
    pay = torch.arange(seg_len, device=length.device)
    length = torch.where(pay < n_valid[:, None], length, 0)
    take = length >= MIN_MATCH
    if lazy:
        nxt = torch.cat([length[:, 1:], torch.zeros_like(length[:, :1])], 1)
        take = take & ~(nxt > length)
    return take, length


def _covering_match(is_match, length, dist, n_valid, seg_len: int):
    """(covered bool[B, seg_len], cov_dist int64[B, seg_len]): for each
    payload position, whether a selected match covers it and that
    match's distance.  Matches never overlap, so the covering match is
    the running maximum of match starts; its (length, dist) ride along
    in the low bits of one int64 cummax key."""
    posn = torch.arange(seg_len, device=length.device)
    key = torch.where(
        is_match,
        ((posn + 1) << 24) | (length.to(torch.int64) << 15)
        | (dist.to(torch.int64) - 1),
        0)
    c = torch.cummax(key, dim=1).values
    cov_start = (c >> 24) - 1
    cov_len = (c >> 15) & 0x1FF
    cov_dist = (c & 0x7FFF) + 1
    covered = ((c > 0) & (posn < cov_start + cov_len)
               & (posn < n_valid[:, None]))
    return covered, cov_dist


def _covered_mismatch(data, is_match, length, dist, n_valid, seg_len, hist):
    """bool[B, seg_len]: the position is covered by a selected match and
    its byte differs from the match's source byte."""
    covered, cov_dist = _covering_match(is_match, length, dist, n_valid,
                                        seg_len)
    posn = torch.arange(seg_len, device=data.device)
    src = torch.gather(data, 1, torch.clamp(hist + posn - cov_dist, min=0))
    return covered & (data[:, hist:hist + seg_len] != src)


def _verify_matches(data, is_match, length, dist, n_valid, seg_len: int,
                    hist: int = HIST) -> torch.Tensor:
    """Exact check of every selected match -> bool[B], True iff every
    covered byte equals its source byte."""
    return ~_covered_mismatch(data, is_match, length, dist, n_valid,
                              seg_len, hist).any(dim=1)


def _summarize_batch(data, n_valid, take, plen, dist, on_path_full,
                     seg_len: int, hist: int):
    """Tail of the analyze passes: the marked parse, the exact
    verification and the symbol histograms."""
    pay = torch.arange(seg_len, device=data.device)
    on_path = on_path_full[:, :seg_len] & (pay < n_valid[:, None])
    is_match = on_path & take
    mlen = torch.where(is_match, plen, 0).to(torch.int32)
    mdist = torch.where(is_match, dist, 0).to(torch.int32)
    exact = _verify_matches(data, is_match, mlen, mdist, n_valid, seg_len,
                            hist)
    hist_lit, hist_dist = hist_cu.histograms(
        on_path, is_match, mlen, mdist, data[:, hist:hist + seg_len])
    return dict(on_path=on_path, is_match=is_match, length=mlen, dist=mdist,
                hist_lit=hist_lit, hist_dist=hist_dist, exact=exact)


def _dist_counts_batch(is_match, dist) -> torch.Tensor:
    """Per-segment exact-distance histograms of the selected matches
    (HOT_DIST_BINS bins, overflow clipped into the last one)."""
    md = torch.clamp(torch.where(is_match, dist, 0), 0, HOT_DIST_BINS - 1)
    out = torch.zeros((is_match.shape[0], HOT_DIST_BINS), dtype=torch.int32,
                      device=is_match.device)
    return out.scatter_add_(1, md.to(torch.int64), is_match.to(torch.int32))


@graphs.program(static=("level", "seg_len", "force_exact", "window_bits", "hist"))
def lz77_analyze(data, n_valid, hist_len, *, level: int, seg_len: int,
                 force_exact: bool = False, window_bits: int = 15,
                 hist: int = HIST) -> dict[str, torch.Tensor]:
    """Match-find + parse a batch of segments (round A).

    data: uint8[B, hist + seg_len]; n_valid: int32[B] payload bytes;
    hist_len: int32[B] valid history bytes, all on one device.  Returns
    the reference's dict over the payload ([B, seg_len]): on_path,
    is_match, length, dist, hist_lit[B, 286] (EOB excluded),
    hist_dist[B, 30], exact[B], cand_length, cand_dist, and for the
    two-round levels dist_counts[B, HOT_DIST_BINS]."""
    cfg = level_config(level)
    if force_exact and not cfg.exact:
        cfg = dataclasses.replace(cfg, exact=True)
    nv = n_valid.to(torch.int64)[:, None]
    valid_lo = hist - hist_len.to(torch.int64)[:, None]
    length, dist = _match_candidates(data, valid_lo, hist + nv, cfg,
                                     max_dist=1 << window_bits, hist=hist)
    take, length = _take_defer(length, n_valid, seg_len, cfg.lazy)
    on_path_full = _mark_batched(take, length, seg_len, _ceil_pow2(seg_len))
    out = _summarize_batch(data, n_valid, take, length, dist, on_path_full,
                           seg_len, hist)
    out["cand_length"] = length
    out["cand_dist"] = dist
    if cfg.two_round:
        out["dist_counts"] = _dist_counts_batch(out["is_match"], out["dist"])
    return out


@graphs.program(static=("seg_len", "hist"))
def lz77_trim_candidates(data, is_match, length, dist, cand_length,
                         cand_dist, n_valid, *, seg_len: int,
                         hist: int = HIST) -> torch.Tensor:
    """Trim each selected candidate the verification caught
    overestimating to its proven-equal prefix (first mismatched byte of
    its covered span); candidates under MIN_MATCH, or length 3 beyond
    TOO_FAR, are dropped."""
    mism = _covered_mismatch(data, is_match, length, dist, n_valid, seg_len,
                             hist)
    posn = torch.arange(seg_len, device=data.device)
    fm = _suffix_min(torch.where(mism, posn, 1 << 22))
    bad = is_match & (fm - posn < length)
    cl = torch.where(bad, torch.minimum(cand_length.to(torch.int64), fm - posn),
                     cand_length.to(torch.int64))
    cl = torch.where(cl >= MIN_MATCH, cl, 0)
    cl = torch.where((cl == MIN_MATCH) & (cand_dist > TOO_FAR), 0, cl)
    return cl.to(torch.int32)


@graphs.program(static=("seg_len", "hist", "lazy", "two_round"))
def lz77_reparse_greedy(data, cand_length, cand_dist, n_valid, *,
                        seg_len: int, hist: int = HIST, lazy: bool = True,
                        two_round: bool = False) -> dict[str, torch.Tensor]:
    """Greedy/lazy take-defer + parse over given candidates: the tail of
    :func:`lz77_analyze` for the trim-and-reparse loop (with
    ``two_round``, dist_counts too)."""
    take, length = _take_defer(cand_length, n_valid, seg_len, lazy)
    on_path_full = _mark_batched(take, length, seg_len, _ceil_pow2(seg_len))
    out = _summarize_batch(data, n_valid, take, length, cand_dist,
                           on_path_full, seg_len, hist)
    out["cand_length"] = length
    out["cand_dist"] = cand_dist
    if two_round:
        out["dist_counts"] = _dist_counts_batch(out["is_match"], out["dist"])
    return out


def _hot_lane(data, n_valid, hist_len, hot, *, seg_len: int, hist: int,
              max_dist: int):
    """Exact strided-run candidates at the mined hot distances
    hot int32[B, HOT_DISTS]: run lengths of data[i] == data[i-d] by one
    suffix scan; per position the longest run wins (ties -> nearer).  A
    distance of 0 is an empty lane; lanes are gated by max_dist and the
    history length.  -> (hot_len, hot_d) int32[B, seg_len]."""
    b = data.shape[0]
    pay = torch.arange(seg_len, device=data.device)
    abs_idx = pay + hist
    hot = hot.to(torch.int64)
    src = torch.clamp(abs_idx - hot[:, :, None], min=0)   # [B, H, S]
    srcs = torch.gather(data, 1, src.reshape(b, -1)).reshape(src.shape)
    runs = _run_lengths(srcs == data[:, None, hist:hist + seg_len])
    n = n_valid.to(torch.int64)[:, None]
    lo = hist - hist_len.to(torch.int64)[:, None]
    hot_len = torch.zeros((b, seg_len), dtype=torch.int64, device=data.device)
    hot_d = torch.zeros_like(hot_len)
    for j in range(HOT_DISTS):
        d_j = hot[:, j:j + 1]
        ok_j = ((abs_idx - d_j >= lo) & (pay < n) & (d_j >= 1)
                & (d_j <= max_dist))
        len_j = torch.where(ok_j, torch.clamp(runs[:, j], max=MAX_MATCH), 0)
        len_j = torch.minimum(len_j, torch.clamp(n - pay, min=0))
        better = (len_j > hot_len) | ((len_j == hot_len) & (d_j < hot_d))
        hot_len = torch.where(better, len_j, hot_len)
        hot_d = torch.where(better, d_j, hot_d)
    return hot_len.to(torch.int32), hot_d.to(torch.int32)


@graphs.program(static=("seg_len", "hist", "lazy", "window_bits"))
def lz77_parse_cost(data, cand_length, cand_dist, n_valid, lit_cost,
                    dist_cost, hist_len=None, hot_dists=None, *,
                    seg_len: int, hist: int = HIST, lazy: bool = True,
                    window_bits: int = 15) -> dict[str, torch.Tensor]:
    """Cost-aware re-parse (round B): round A's candidates re-taken with
    exact bit costs (lit_cost [B, 286], dist_cost [B, 30], small integer
    code lengths in any dtype).  A match is taken when its coded bits
    undercut the literals it covers, and lazy deferral compares bit
    gains.  The reference's kernel-branch order, in int32: literal bits
    and their exclusive prefix sum (one kernel), the optional hot-stride
    lane (hot_dists int32[B, HOT_DISTS]), gains (kernel), take/defer, then
    the mark path and the histograms.  Costs are small integers and the
    prefix stays below 2^24, so the integers equal the reference's
    float32 branch; the NEG_GAIN sentinel never decides a take because
    a take requires gain > 0."""
    if hist_len is None:
        hist_len = torch.zeros_like(n_valid)
    max_dist = 1 << window_bits
    pay = torch.arange(seg_len, device=data.device)
    length = torch.where(pay < n_valid[:, None], cand_length, 0)
    length = torch.where(cand_dist <= max_dist, length, 0)
    lcost = lit_cost.to(torch.int32).contiguous()
    dcost = dist_cost.to(torch.int32).contiguous()
    litbits, pref = cost_cu.litbits_pref(data[:, hist:hist + seg_len], lcost)
    hot_len = hot_d = None
    if hot_dists is not None:
        hot_len, hot_d = _hot_lane(data, n_valid, hist_len, hot_dists,
                                   seg_len=seg_len, hist=hist,
                                   max_dist=max_dist)
    length, dist, gain = cost_cu.gain(length, cand_dist.contiguous(), hot_len,
                                      hot_d, pref, lcost, dcost)
    take = (length >= MIN_MATCH) & (gain > 0)
    if lazy:
        nxt = torch.cat([gain[:, 1:],
                         torch.full_like(gain[:, :1], cost_cu.NEG_GAIN)], 1)
        take = take & ~(nxt - litbits > gain)
    on_path_full = _mark_batched(take, length, seg_len, _ceil_pow2(seg_len))
    return _summarize_batch(data, n_valid, take, length, dist, on_path_full,
                            seg_len, hist)


@profiling.spanned("roundb.tables", cpu=True)
def _hot_dists_host(dist_counts):
    """Top strided distances per segment from the round-A exact-distance
    histogram (host).  Distances <= 4 are covered by the always-on run
    scan; low-count strides are not worth a candidate lane."""
    b = dist_counts.shape[0]
    hot = np.zeros((b, HOT_DISTS), np.int32)
    for i in range(b):
        c = dist_counts[i].copy()
        c[:5] = 0
        # the histogram clips distances >= HOT_DIST_BINS into the last
        # bin — it is an overflow counter, not a real stride
        c[HOT_DIST_BINS - 1] = 0
        top = np.argpartition(c, -HOT_DISTS)[-HOT_DISTS:]
        top = top[np.argsort(-c[top])]
        for j, d in enumerate(top):
            if c[d] >= 64:
                hot[i, j] = d
    return hot


#: rows tabled by :func:`_cost_tables_host`, and ``overflow``: rows whose
#: literal or distance tree was redistributed to fit 15 bits.  Always on.
TABLE_COUNTS: collections.Counter = collections.Counter()


@profiling.spanned("roundb.tables", cpu=True)
def _cost_tables_host(hist_lit, hist_dist):
    """Round-A histograms -> float32 bit-cost tables (host).

    Canonical code lengths from the round-A distribution; symbols the
    round-A parse never produced get a pessimistic-but-usable default
    so round B may still introduce them when clearly profitable.

    One native call tables the batch (``native/plan.cpp``); its output
    is the reference's ``_cost_tables_host``' exactly.
    """
    lit_cost, dist_cost, overflow = native.cost_tables(hist_lit, hist_dist)
    TABLE_COUNTS.update(rows=lit_cost.shape[0], overflow=overflow)
    return lit_cost, dist_cost


#: the entries of a result the host reads: exactness, then the histograms
#: (round B's cost tables, the mining, the block plan)
_HOST_KEYS = ("exact", "hist_lit", "hist_dist", "dist_counts")


def _queued(res: dict) -> transfer.Queued:
    """``res`` with the copies of its host-read entries queued right
    behind the work that made them (see ``transfer``)."""
    return transfer.Queued(res, [k for k in _HOST_KEYS if k in res])


def _all_exact(res) -> bool:
    (exact,) = transfer.read(res, "exact")
    return bool(exact.all())


def _repair_greedy(res, data, n_valid, hist_len, *, level: int, seg_len: int,
                   window_bits: int, hist: int,
                   two_round: bool) -> dict[str, torch.Tensor]:
    """Make an inexact round A byte-exact with no round B: trim its
    candidates and re-parse (with ``two_round``, dist_counts too) up to
    _TRIM_RETRIES times, then re-run with exact extension."""
    lazy = level_config(level).lazy
    cl, cd = res["cand_length"], res["cand_dist"]
    for _ in range(_TRIM_RETRIES):
        cl = lz77_trim_candidates(data, res["is_match"], res["length"],
                                  res["dist"], cl, cd, n_valid,
                                  seg_len=seg_len, hist=hist)
        res = _queued(lz77_reparse_greedy(data, cl, cd, n_valid, seg_len=seg_len,
                                          hist=hist, lazy=lazy, two_round=two_round))
        if _all_exact(res):
            return res
    return _queued(lz77_analyze(data, n_valid, hist_len, level=level, seg_len=seg_len,
                                force_exact=True, window_bits=window_bits, hist=hist))


def analyze2_finish(res, data, n_valid, hist_len, *, level: int,
                    seg_len: int, window_bits: int = 15,
                    hist: int = HIST) -> dict[str, torch.Tensor]:
    """Finish a round-A result: repair it until it is byte-exact and, for
    the two-round levels, run the cost-aware round B on its candidates.

    Greedy levels repair an inexact round A with :func:`_repair_greedy`.
    At the two-round levels an inexact round A has its candidates
    trimmed first; then bit-cost tables are built from round A's
    (unrepaired) histograms, hot strides mined, and round B run up to
    _TRIM_RETRIES times, trimming after each inexact pass; then one
    exact-extension round A feeds a final, unchecked round B."""
    cfg = level_config(level)
    cd = res["cand_dist"]

    def trim(r, cl):
        return lz77_trim_candidates(data, r["is_match"], r["length"],
                                    r["dist"], cl, cd, n_valid,
                                    seg_len=seg_len, hist=hist)

    cl = res["cand_length"]
    exact_a = cfg.exact or _all_exact(res)
    if not cfg.two_round:
        if exact_a:
            return res
        return _repair_greedy(res, data, n_valid, hist_len, level=level,
                              seg_len=seg_len, window_bits=window_bits,
                              hist=hist, two_round=False)
    if not exact_a:
        cl = trim(res, cl)

    dev = data.device
    lit_cost, dist_cost = _cost_tables_host(*transfer.read(res, "hist_lit", "hist_dist"))
    hot = None
    if cfg.mine:
        hot_np = _hot_dists_host(*transfer.read(res, "dist_counts"))
        if hot_np.any():  # all-zero rows: skip the hot lane
            hot = transfer.upload(hot_np, dev)
    lc = transfer.upload(lit_cost.astype(np.int32), dev)
    dc = transfer.upload(dist_cost.astype(np.int32), dev)

    def round_b(cand_length, cand_dist):
        return _queued(lz77_parse_cost(data, cand_length, cand_dist, n_valid, lc, dc,
                                       hist_len, hot, seg_len=seg_len, hist=hist,
                                       lazy=cfg.lazy, window_bits=window_bits))

    for _ in range(_TRIM_RETRIES):
        res2 = round_b(cl, cd)
        if _all_exact(res2):
            return res2
        cl = trim(res2, cl)
    # trims keep surfacing collisions: exact-extension round A
    resx = lz77_analyze(data, n_valid, hist_len, level=level,
                        seg_len=seg_len, force_exact=True,
                        window_bits=window_bits, hist=hist)
    return round_b(resx["cand_length"], resx["cand_dist"])


def analyze(data, n_valid, hist_len, *, level: int, seg_len: int,
            window_bits: int = 15, hist: int = HIST) -> dict[str, torch.Tensor]:
    """Round A (:func:`lz77_analyze`) made byte-exact, with no round B:
    fingerprint overestimates the verification reports are repaired by
    the trim-and-reparse loop, and if trims keep surfacing collisions
    after _TRIM_RETRIES passes, by an exact-extension re-run.

    ``window_bits`` (8..15) restricts match distances for small windows."""
    cfg = level_config(level)
    res = lz77_analyze(data, n_valid, hist_len, level=level, seg_len=seg_len,
                       window_bits=window_bits, hist=hist)
    if cfg.exact or _all_exact(res):
        return res
    return _repair_greedy(res, data, n_valid, hist_len, level=level,
                          seg_len=seg_len, window_bits=window_bits, hist=hist,
                          two_round=cfg.two_round)


def analyze2_start(data, n_valid, hist_len, *, level: int, seg_len: int,
                   window_bits: int = 15, hist: int = HIST) -> dict[str, torch.Tensor]:
    """Round A with no host sync, so a caller can queue several batches'
    round A on the card before the first :func:`analyze2_finish`.  The
    copies of what the host reads of it (exactness and histograms) are
    queued right behind it, so that finish waits for this batch only."""
    return _queued(lz77_analyze(data, n_valid, hist_len, level=level, seg_len=seg_len,
                                window_bits=window_bits, hist=hist))


def state_from_numpy(res: dict, device) -> dict[str, torch.Tensor]:
    """Stage arrays (e.g. the reference's round-A result dict) as
    tensors on ``device``, dtypes kept (bool stays bool, int32 int32)."""
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in res.items()}


def state_to_numpy(state: dict) -> dict[str, np.ndarray]:
    """Inverse of :func:`state_from_numpy`."""
    return {k: v.cpu().numpy() for k, v in state.items()}
