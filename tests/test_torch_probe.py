"""Round A's candidate search (``ops/probe_cu``) == the reference's, on
the CPU.

``lz77._match_candidates`` of the port (its plain versions
``fields_plain``, ``probe_plain`` and ``extend_plain``) against the reference's
``ops/lz77.py: _match_candidates`` vmapped over rows, exact ``(length,
dist)``: levels 1, 4, 5, 6, 7, 12, 100 and 101, ``window_bits`` 9 and 15,
``force_exact``, on a batch of short segments (32 KiB history cut to
1 KiB, 3,000-byte payloads, T off the probe tile) holding corpus text
with full, partial and no history, an all-zero row, a periodic row and
random bytes.  ``fields_plain`` against the reference's words,
fingerprints, field tuples, ``(hash, pos)`` key order and run lengths
(capped at 258) at levels 1, 4, 6 and 12 with and without
``force_exact``, with and without history, at T = 4,999 and 4,097 on
text, a one-byte row and random bytes.  Then CPU models of the kernels'
tiling (``csrc/probe.cu``): the fields kernel's tiles with their halos
wrapping mod T (more than once where T is under the 223 bytes a record
reads) and the runs' bitmap scan, held equal to ``fields_plain``; the
probe kernel's tiles of ranks staged with the K ranks before them, a
thread per rank walking its predecessors with the kernel's early stops,
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
    """The fields', probe's and extend's arguments in ``_match_candidates``
    of :func:`_rows` at this level."""
    return chip_smoke.captured_args(
        probe_cu, ("fields", "probe", "extend"),
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
    the tile's ranks' keys and records and the K before them (none before
    the row start) staged, then one thread per rank walking k = 1..min(K,
    staged index) with the kernel's updates and its one stop: a
    predecessor's key under ``base + (max(valid_lo, pos - max_dist, 0) <<
    KEY_LOW)`` (base: the rank's key cut to its hash); a word from its
    key's low bits and the rank's hash, times HASH_MUL_INV; threads as a
    tensor axis."""
    b_rows, t = skey.shape
    mask = (1 << pos_bits) - 1
    low, inv = probe_cu.KEY_LOW, probe_cu.HASH_MUL_INV

    def word(h, kj):  # (h << KEY_LOW | low bits) * HASH_MUL_INV mod 2^32
        return (((h << low) | (kj & ((1 << low) - 1))) * inv) & 0xFFFFFFFF

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
        s_key = skey[b][staged.clamp(max=t - 1)]
        s_pos = (s_key >> low) & mask
        s_rec = rec[b].to(torch.int64)[s_pos] & 0xFFFFFFFF     # [nt, span, R - 1]
        live = li < n[:, None]
        lic = li.clamp(max=span - 1)
        key = torch.gather(s_key, 1, lic)
        p = (key >> low) & mask
        h = key >> (pos_bits + low)
        base = h << (pos_bits + low)
        stop = base + (torch.clamp(torch.clamp(p - max_dist, min=int(valid_lo[b])), min=0)
                       << low)
        f = torch.cat([word(h, key)[..., None], torch.gather(
            s_rec, 1, lic[:, :, None].expand(-1, -1, s_rec.shape[2]))], -1)
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
            kj = torch.gather(s_key, 1, ljc)
            walking = walking & (kj >= stop)
            cp = (kj - base) >> low
            x = f ^ torch.cat([word(h, kj)[..., None], torch.gather(
                s_rec, 1, ljc[:, :, None].expand(-1, -1, s_rec.shape[2]))], -1)
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
    no winner anywhere; the extend modes and the fields' outputs follow
    the level config; the key carries the word, the full ladder's record
    the other 8 fields."""
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
    assert probe_cu.RECORD_STRIDE[True] == args[2].shape[2] == 8
    assert probe_cu.RECORD_STRIDE[False] == calls[4]["probe"][0][2].shape[2] == 4
    assert calls[4]["fields"][1]["spans"] and not calls[6]["fields"][1]["spans"]
    assert calls[100]["fields"][1]["runs"]


FIELD_T = (4999, 4097)  # off every tile; just over a power of two


def _field_rows(t):
    """uint8[3, t]: corpus text, a row of one repeated byte, random bytes."""
    raw = np.frombuffer((CORPUS / "paper1").read_bytes(), np.uint8)
    data = np.zeros((3, t), np.uint8)
    data[0] = raw[5000:5000 + t]
    data[1] = 0x61
    data[2] = np.random.default_rng(16).integers(0, 256, t, dtype=np.uint8)
    return data


@functools.lru_cache(maxsize=None)
def _ref_fields(t, hist):
    """The reference's record build of :func:`_field_rows`, row by row:
    its words and fingerprints (``_u32_words``, ``_fingerprints``), its
    field tuples (``decompress_tpu/ops/lz77.py:317-329``), its ``(hash,
    pos)`` sort and its capped-later runs (``_run_length_scan_multi``)."""
    mul = jnp.uint32(2654435761)

    def h16(x):
        return (x * mul) >> jnp.uint32(16)

    def pack2(a, b):
        return (h16(a) << 16) | h16(b)

    def one(row):
        w = ref._u32_words(row)
        fp = ref._fingerprints(w)
        full = (w, jnp.roll(w, -4), fp[16],
                pack2(jnp.roll(w, -6), jnp.roll(fp[8], -4)),
                pack2(jnp.roll(w, -10), jnp.roll(w, -16)),
                pack2(jnp.roll(fp[16], -8), fp[32]),
                pack2(jnp.roll(fp[16], -32), fp[64]),
                pack2(jnp.roll(fp[32], -64), fp[128]),
                pack2(jnp.roll(fp[32], -192), jnp.roll(fp[64], -128)))
        short = (w, jnp.roll(w, -4), fp[16], fp[64])
        h = ((w * mul) >> jnp.uint32(32 - ref.HASH_BITS)).astype(jnp.int32)
        sh, sp = jax.lax.sort((h, jnp.arange(t, dtype=jnp.int32)), num_keys=2)
        eqs = jnp.stack([(row == jnp.roll(row, d))[hist:] for d in (1, 2, 3, 4)])
        return dict(w=w, h=h, sh=sh, sp=sp, full=jnp.stack(full, 1),
                    short=jnp.stack(short, 1), runs=ref._run_length_scan_multi(eqs),
                    spans=jnp.stack([fp[s] for s in probe_cu.SPAN_FPS]))

    out = jax.jit(jax.vmap(one))(jnp.asarray(_field_rows(t)))
    return {k: np.asarray(v) for k, v in out.items()}


def _fields_kw(level, force_exact):
    cfg = lz77.level_config(level)
    exact = force_exact or cfg.exact
    return dict(full_ladder=cfg.full_ladder, spans=not exact and not cfg.full_ladder,
                runs=cfg.runs)


@pytest.mark.parametrize("t", FIELD_T)
@pytest.mark.parametrize("hist", [0, 300])
@pytest.mark.parametrize("level,force_exact", [
    (1, False), (4, False), (6, False), (12, False), (1, True), (4, True), (6, True),
    (12, True)])
def test_fields_plain_match_reference(level, force_exact, hist, t):
    """``fields_plain`` == the reference's words, hashes and (hash, pos)
    order of the keys, the word each key carries, the other probe fields
    (the padding zero), span fingerprints and runs (capped at MAX_MATCH)
    on text, a one-byte row and random bytes, exactly."""
    want = _ref_fields(t, hist)
    kw = _fields_kw(level, force_exact)
    w, key, rec, spans, runs = probe_cu.fields_plain(
        torch.from_numpy(_field_rows(t)), hist=hist, **kw)
    bits = probe_cu.key_bits(t)
    np.testing.assert_array_equal(w.numpy(), want["w"].astype(np.int64))
    pos, h, kw_word = probe_cu.key_parts(key, bits)
    np.testing.assert_array_equal(h.numpy(), want["h"])
    np.testing.assert_array_equal(pos.numpy(), np.broadcast_to(np.arange(t), (3, t)))
    np.testing.assert_array_equal(kw_word.numpy(), want["w"].astype(np.int64))
    spos, sh, _ = probe_cu.key_parts(torch.sort(key, dim=1).values, bits)
    np.testing.assert_array_equal(sh.numpy(), want["sh"])
    np.testing.assert_array_equal(spos.numpy(), want["sp"])
    ladder = want["full" if kw["full_ladder"] else "short"]
    r = ladder.shape[2]  # the key carries field 0, the record the rest
    assert rec.shape == (3, t, probe_cu.RECORD_STRIDE[kw["full_ladder"]])
    np.testing.assert_array_equal(rec[..., :r - 1].numpy().view(np.uint32), ladder[..., 1:])
    assert not bool(rec[..., r - 1:].any())
    assert (spans is None) == (not kw["spans"])
    if spans is not None:
        np.testing.assert_array_equal(torch.stack(spans).numpy(),
                                      want["spans"].transpose(1, 0, 2).astype(np.int64))
    assert (runs is None) == (not kw["runs"])
    if runs is not None:
        np.testing.assert_array_equal(
            runs.numpy(), np.minimum(want["runs"], 258).transpose(1, 0, 2))
        # the one-byte row: runs of 258 that shorten to 1 at the row end
        assert bool((runs[:, 1, 0] == 258).all()) and bool((runs[:, 1, -1] == 1).all())


def _mix_np(a, b):
    rot = (b << np.uint32(13)) | (b >> np.uint32(19))
    return (a ^ rot) * np.uint32(probe_cu.HASH_MUL)


def _pack2_np(a, b):
    mul = np.uint32(probe_cu.HASH_MUL)
    return (((a * mul) >> np.uint32(16)) << np.uint32(16)) | ((b * mul) >> np.uint32(16))


def fields_model(data, *, hist, full_ladder, spans, runs, tile):
    """csrc/probe.cu's fields_kernel on the CPU, one block per (row, tile
    of positions) as a tensor axis: the tile's bytes staged from t0 - 4
    to the end of the runs' bitmap, every index mod T; the words and the
    pyramid's levels each as far past the tile as the records read them;
    the runs from a bitmap of 32-position words (false past the row end),
    each word's first false position and their suffix minimum."""
    b_rows, t = data.shape
    u32 = np.uint32
    run_words = (tile + 258 + 31) // 32
    nt = -(-t // tile)
    t0 = np.arange(nt) * tile
    sb = data[:, (t0[:, None] - 4 + np.arange(4 + 32 * run_words)[None]) % t].astype(u32)
    k64, k32 = tile + 128, tile + 192
    k16, k8 = k32 + 16, k32 + 24
    kw = k8 + 4
    w = sb[..., 4:4 + kw] | (sb[..., 5:5 + kw] << u32(8)) | (sb[..., 6:6 + kw] << u32(16)) \
        | (sb[..., 7:7 + kw] << u32(24))
    pm = w * u32(probe_cu.PREMIX_MUL)
    f8 = _mix_np(pm[..., :k8], pm[..., 4:4 + k8])
    f16 = _mix_np(f8[..., :k16], f8[..., 8:8 + k16])
    f32 = _mix_np(f16[..., :k32], f16[..., 16:16 + k32])
    f64 = _mix_np(f32[..., :k64], f32[..., 32:32 + k64])
    i = np.arange(tile)
    f128 = _mix_np(f64[..., i], f64[..., i + 64])
    if full_ladder:
        recs = [w[..., i + 4], f16[..., i], _pack2_np(w[..., i + 6], f8[..., i + 4]),
                _pack2_np(w[..., i + 10], w[..., i + 16]), _pack2_np(f16[..., i + 8], f32[..., i]),
                _pack2_np(f16[..., i + 32], f64[..., i]), _pack2_np(f32[..., i + 64], f128),
                _pack2_np(f32[..., i + 192], f64[..., i + 128])]
    else:
        recs = [w[..., i + 4], f16[..., i], f64[..., i], np.zeros_like(f128)]
    rec = np.stack(recs, -1)
    pos = t0[:, None] + i[None]                       # [nt, tile]
    live = pos < t
    m = (w[..., i] * u32(probe_cu.HASH_MUL)).astype(np.int64)
    low = probe_cu.KEY_LOW
    key = ((m >> low) << (probe_cu.key_bits(t) + low)) | (pos << low) | (m & ((1 << low) - 1))

    def scatter(a):  # [B, nt, tile, ...] -> [B, T, ...], positions past T dropped
        return a[:, live]

    out_runs = None
    if runs:
        j = np.arange(32 * run_words)
        out_runs = np.zeros((4, b_rows, t - hist), np.int32)
        for d in range(1, 5):
            eq = ((t0[:, None] + j[None]) < t) & (sb[..., 4 + j] == sb[..., 4 + j - d])
            bits = (eq.reshape(b_rows, nt, run_words, 32).astype(np.uint64)
                    << np.arange(32, dtype=np.uint64)).sum(-1).astype(u32)
            low = ~bits & (bits + u32(1))                  # lowest false bit of each word
            first = np.where(bits == u32(0xFFFFFFFF), 1 << 30,
                             32 * np.arange(run_words) + np.log2(np.maximum(low, 1)).astype(int))
            nxt = np.concatenate([np.minimum.accumulate(first[..., ::-1], -1)[..., ::-1],
                                  np.full((b_rows, nt, 1), 1 << 30)], -1)
            k = i >> 5
            frm = ~bits[..., k] & (u32(0xFFFFFFFF) << (i & 31).astype(u32))
            lowf = frm & (~frm + u32(1))
            nf = np.where(frm != 0, 32 * k + np.log2(np.maximum(lowf, 1)).astype(int),
                          nxt[..., k + 1])
            run = np.minimum(nf - i, 258)
            out_runs[d - 1] = scatter(run)[:, hist:]
    span_fps = None
    if spans:
        span_fps = tuple(scatter(a) for a in (f128, f64[..., i], f32[..., i], f16[..., i],
                                              f8[..., i]))
    return scatter(w[..., i]), scatter(key), scatter(rec), span_fps, out_runs


@pytest.mark.parametrize("t,hist,tile", [(4999, 300, probe_cu.FIELDS_TILE), (4999, 0, 64), (4097, 300, 100),
                                         (150, 0, 32), (37, 0, 16), (130, 2, probe_cu.FIELDS_TILE)])
@pytest.mark.parametrize("level", [4, 6])
def test_fields_tiling_model_matches_plain(level, t, hist, tile):
    """Tiles of 16-1024 positions whose halos run past the row end (and
    wrap more than once where T is under the 223 bytes a record reads),
    the runs' bitmap scan at every tile: equal to ``fields_plain``."""
    data = _field_rows(max(t, 400))[:, :t].copy()
    data[0, t // 2:] = data[0, :t - t // 2]  # a long match, runs to the row end
    kw = dict(_fields_kw(level, False), runs=True)
    want = probe_cu.fields_plain(torch.from_numpy(data), hist=hist, **kw)
    got = fields_model(data, hist=hist, tile=tile, **kw)
    for name, g, wt in zip(("w", "key", "rec", "spans", "runs"), got, want):
        assert (g is None) == (wt is None), name
        if wt is None:
            continue
        wt = torch.stack(wt).numpy() if isinstance(wt, tuple) else wt.numpy()
        g = np.stack(g) if isinstance(g, tuple) else g
        np.testing.assert_array_equal(g.astype(np.int64) & 0xFFFFFFFF if name == "rec" else g,
                                      wt.astype(np.int64) & 0xFFFFFFFF if name == "rec"
                                      else wt, err_msg=name)
    assert int(want[4].max()) == 258 if t > 300 else True


def test_constants_match_reference():
    assert probe_cu.TOO_FAR == lz77.TOO_FAR == ref.TOO_FAR
    assert probe_cu.MAX_MATCH == ref.MAX_MATCH and probe_cu.MIN_MATCH == ref.MIN_MATCH
    assert max(cfg.k_candidates for cfg in lz77.LEVELS.values()) <= probe_cu.MAX_K
    assert probe_cu.NEG_INF == -(1 << 30)
