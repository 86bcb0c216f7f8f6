"""Round A's candidate search (``ops/probe_cu``) == the reference's, on
the CPU.

``lz77._match_candidates`` of the port (its plain versions
``probe_plain`` and ``extend_plain``) against the reference's
``ops/lz77.py: _match_candidates`` vmapped over rows, exact ``(length,
dist)``: levels 1, 4, 5, 6, 7, 12, 100 and 101, ``window_bits`` 9 and 15,
``force_exact``, on a batch of short segments (32 KiB history cut to
1 KiB, 3,000-byte payloads, T off the probe tile) holding corpus text
with full, partial and no history, an all-zero row, a periodic row and
random bytes.  Then a CPU model of the probe kernel's tiling
(``csrc/probe.cu``): tiles of ranks staged with the K ranks before them,
a thread per rank walking its predecessors with the kernel's early stops,
held equal to ``probe_plain`` at tile sizes that cut each row into many
tiles (K larger and smaller than a tile, halos crossing tile boundaries
and the row start); and the wrappers' CPU dispatch, K = 0, and the copied
constants.
"""

import dataclasses
import functools
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from decompress_tpu.ops import lz77 as ref
from decompress_tpu_torch import _build
from decompress_tpu_torch.ops import lz77, probe_cu
from torch_threads import one_torch_thread  # noqa: F401

CORPUS = pathlib.Path(__file__).parent / "corpus"
HIST = 1024
SEG = 3000  # T = 4,024: not a multiple of the probe tile


def _rows():
    """(data uint8[6, HIST + SEG], n_valid, hist_len): corpus text behind
    full, no and partial history, all zeros, a period-7 pattern and random
    bytes (a short payload among them)."""
    raw = np.frombuffer((CORPUS / "paper1").read_bytes(), np.uint8)
    rng = np.random.default_rng(14)
    t = HIST + SEG
    data = np.zeros((6, t), np.uint8)
    data[0] = raw[:t]
    data[1] = raw[t:2 * t]
    data[2] = raw[2 * t:3 * t]
    data[4] = np.resize(np.frombuffer(b"abcdefg", np.uint8), t)
    data[5] = rng.integers(0, 256, t, dtype=np.uint8)
    n_valid = np.array([SEG, SEG, SEG - 700, SEG, SEG, SEG], np.int32)
    hist_len = np.array([HIST, 0, 300, HIST, HIST, 37], np.int32)
    return data, n_valid, hist_len


@functools.lru_cache(maxsize=None)
def _ref_fn(level, force_exact, window_bits):
    cfg = ref.LEVELS[level]
    if force_exact:
        cfg = dataclasses.replace(cfg, exact=True)

    def one(seg, n, hl):
        return ref._match_candidates(seg, HIST - hl, HIST + n, cfg,
                                     max_dist=1 << window_bits, hist=HIST)

    return jax.jit(jax.vmap(one))


def _port(data, n_valid, hist_len, level, force_exact, window_bits):
    cfg = lz77.level_config(level)
    if force_exact:
        cfg = dataclasses.replace(cfg, exact=True)
    valid_lo = HIST - torch.from_numpy(hist_len).to(torch.int64)[:, None]
    valid_hi = HIST + torch.from_numpy(n_valid).to(torch.int64)[:, None]
    return lz77._match_candidates(torch.from_numpy(data), valid_lo, valid_hi, cfg,
                                  max_dist=1 << window_bits, hist=HIST)


@pytest.mark.parametrize("level,force_exact,window_bits", [
    *((lv, False, wb) for lv in (1, 4, 5, 6, 7, 12, 100, 101) for wb in (9, 15)),
    (1, True, 15), (4, True, 15), (6, True, 9), (12, True, 15)])
def test_match_candidates_match_reference(level, force_exact, window_bits):
    data, n_valid, hist_len = _rows()
    want_len, want_dist = _ref_fn(level, force_exact, window_bits)(
        jnp.asarray(data), jnp.asarray(n_valid), jnp.asarray(hist_len))
    got_len, got_dist = _port(data, n_valid, hist_len, level, force_exact, window_bits)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_array_equal(got_dist.numpy(), np.asarray(want_dist))
    if level not in (100, 101):  # every level with candidates finds some here
        assert (got_len.numpy()[0] >= 3).sum() > 100
        assert (got_len.numpy()[3] == 258).any()  # the zero row's runs


def _probe_calls(level, force_exact=False, window_bits=15):
    """The probe's and extend's arguments in ``_match_candidates`` of
    :func:`_rows` at this level."""
    return chip_smoke.captured_args(
        probe_cu, ("probe", "extend"),
        lambda: _port(*_rows(), level, force_exact, window_bits))


def _pbe(x):
    """The kernel's prefix_bytes_equal: 4 for 0, else the zero low bytes."""
    low = x & -x  # lowest set bit
    return torch.where(x == 0, 4, ((low >= 1 << 8).to(torch.int64)
                                   + (low >= 1 << 16).to(torch.int64)
                                   + (low >= 1 << 24).to(torch.int64)))


def _rung_grade(x, full_ladder):
    """The kernel's rung_grade: the chain of rungs over fields 2..R-1."""
    if not full_ladder:
        return torch.where(x[..., 2] != 0, 0, torch.where(x[..., 3] != 0, 8, 56))
    hi, lo = 0xFFFF0000, 0xFFFF
    hits = [(x[..., 3] & hi) == 0, (x[..., 3] & lo) == 0, (x[..., 4] & hi) == 0,
            x[..., 2] == 0, (x[..., 4] & lo) == 0, (x[..., 5] & hi) == 0,
            (x[..., 5] & lo) == 0, (x[..., 6] & hi) == 0, (x[..., 6] & lo) == 0,
            (x[..., 7] & hi) == 0, (x[..., 7] & lo) == 0, (x[..., 8] & lo) == 0,
            (x[..., 8] & hi) == 0]
    weights = (2, 2, 2, 2, 4, 4, 8, 16, 16, 32, 32, 64, 32)
    g = torch.zeros_like(x[..., 0])
    chain = torch.ones_like(hits[0])
    for hit, wgt in zip(hits, weights):
        chain = chain & hit
        g = g + torch.where(chain, wgt, 0)
    return g


def _pack(score, cand, p4, pos):
    has = score > probe_cu.NEG_INF
    grade = torch.where(has, ((score + (pos - cand)) >> 17).clamp(0, 258), 0)
    return ((cand.clamp(min=0) << 12) | (grade << 3)
            | (torch.where(p4 >= 4, 2, 1) << 1) | has.to(torch.int64))


def probe_model(skey, pos_bits, rec, valid_lo, valid_hi, *, hist, max_dist, k,
                full_ladder, top2, tile):
    """csrc/probe.cu's probe_kernel on the CPU, one block per (row, tile):
    the tile's ranks and the K before it (none before the row start)
    staged, then one thread per rank walking k = 1..min(K, staged index)
    with the kernel's stops and updates, threads as a tensor axis."""
    b_rows, t = skey.shape
    mask = (1 << pos_bits) - 1
    out = torch.full((b_rows, t - hist), -1, dtype=torch.int64)
    out2 = torch.full_like(out, -1)
    nt = -(-t // tile)
    r0 = torch.arange(nt) * tile
    lo = (r0 - k).clamp(min=0)
    n = torch.minimum(r0 + tile, torch.tensor(t)) - lo
    span = tile + k
    staged = lo[:, None] + torch.arange(span)[None]            # [nt, span]
    li = r0[:, None] + torch.arange(tile)[None] - lo[:, None]  # [nt, tile]
    for b in range(b_rows):
        key = skey[b][staged.clamp(max=t - 1)]
        s_pos, s_hash = key & mask, key >> pos_bits
        s_rec = rec[b].to(torch.int64)[s_pos] & 0xFFFFFFFF     # [nt, span, R]
        live = li < n[:, None]
        lic = li.clamp(max=span - 1)
        p = torch.gather(s_pos, 1, lic)
        h = torch.gather(s_hash, 1, lic)
        f = torch.gather(s_rec, 1, lic[:, :, None].expand(-1, -1, s_rec.shape[2]))
        live = live & (p >= hist)
        walking = live & (p < int(valid_hi[b]))
        best = torch.full_like(p, probe_cu.NEG_INF)
        best_cand, best_p4 = torch.zeros_like(p), torch.zeros_like(p)
        second, cand2, p42 = best.clone(), best_cand.clone(), best_p4.clone()
        for kk in range(1, k + 1):
            lj = li - kk
            walking = walking & (kk <= torch.clamp(li, max=k))
            assert not bool((walking & ((lj < 0) | (lj >= n[:, None]))).any())
            ljc = lj.clamp(0, span - 1)
            cp = torch.gather(s_pos, 1, ljc)
            walking = walking & (torch.gather(s_hash, 1, ljc) == h) \
                & (p - cp <= max_dist) & (cp >= int(valid_lo[b]))
            x = f ^ torch.gather(s_rec, 1, ljc[:, :, None].expand_as(f))
            plen4 = _pbe(x[..., 0])
            usable = walking & (plen4 >= 3)
            grade = plen4 + torch.where(
                x[..., 0] == 0,
                _pbe(x[..., 1]) + torch.where(x[..., 1] == 0,
                                              _rung_grade(x, full_ladder), 0), 0)
            score = (grade << 17) - (p - cp)
            better = usable & (score > best)
            if top2:
                b2 = usable & ~better & (score > second)
                second = torch.where(better, best, torch.where(b2, score, second))
                cand2 = torch.where(better, best_cand, torch.where(b2, cp, cand2))
                p42 = torch.where(better, best_p4, torch.where(b2, plen4, p42))
            best = torch.where(better, score, best)
            best_cand = torch.where(better, cp, best_cand)
            best_p4 = torch.where(better, plen4, best_p4)
        at = p[live] - hist
        out[b, at] = _pack(best, best_cand, best_p4, p)[live]
        out2[b, at] = _pack(second, cand2, p42, p)[live]
    assert not bool((out < 0).any())  # every payload position written once
    return out, out2 if top2 else None


@pytest.mark.parametrize("level,tile", [(4, 7), (4, 256), (6, 5), (6, 64),
                                        (12, 100), (12, 256), (7, 24)])
def test_probe_tiling_model_matches_plain(level, tile):
    """Tiles of 5-256 ranks with K = 8-128: halos longer and shorter than
    a tile, crossing tile boundaries and cut at every row's start."""
    args, kw = _probe_calls(level)["probe"]
    want = probe_cu.probe_plain(*args, **kw)
    got = probe_model(*args, **kw, tile=tile)
    assert torch.equal(got[0], want[0])
    assert (got[1] is None) == (want[1] is None)
    if want[1] is not None:
        assert torch.equal(got[1], want[1])
    assert int((want[0] & 1).sum()) > 1000  # winners to place


@pytest.mark.parametrize("window_bits", [9, 15])
def test_probe_tiling_model_window(window_bits):
    """The max_dist stop at a small window and at the full one."""
    args, kw = _probe_calls(6, window_bits=window_bits)["probe"]
    got = probe_model(*args, **kw, tile=probe_cu.TILE)
    assert torch.equal(got[0], probe_cu.probe_plain(*args, **kw)[0])


def test_wrappers_take_plain_on_cpu():
    """CPU tensors take the plain versions and count no launch; K = 0 is
    no winner anywhere; the extend modes follow the level config."""
    before = dict(_build.LAUNCHES)
    calls = {lv: _probe_calls(lv) for lv in (4, 6, 7, 100)}
    assert dict(_build.LAUNCHES) == before
    assert calls[4]["extend"][1]["mode"] == "span"
    assert calls[6]["extend"][1]["mode"] == "rec"
    assert calls[7]["extend"][0][2] is not None  # top2: the runner-up
    assert _probe_calls(7, force_exact=True)["extend"][1]["mode"] == "exact"
    packed, packed2 = probe_cu.probe(*calls[100]["probe"][0], **calls[100]["probe"][1])
    assert packed2 is None and bool((packed == probe_cu.NO_WINNER).all())
    args, kw = calls[6]["probe"]
    assert probe_cu.RECORD_WIDTH[True] == args[2].shape[2] == 9
    assert probe_cu.RECORD_WIDTH[False] == calls[4]["probe"][0][2].shape[2] == 4


def test_constants_match_reference():
    assert probe_cu.TOO_FAR == lz77.TOO_FAR == ref.TOO_FAR
    assert probe_cu.MAX_MATCH == ref.MAX_MATCH and probe_cu.MIN_MATCH == ref.MIN_MATCH
    assert max(cfg.k_candidates for cfg in lz77.LEVELS.values()) <= probe_cu.MAX_K
    assert probe_cu.NEG_INF == -(1 << 30)
