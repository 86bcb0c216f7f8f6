"""Device bit packer (torch): per-position slot pairs -> DEFLATE words.

Counterpart of ``decompress_tpu/ops/bitpack.py: pack_slot_planes``, a
two-pass data-parallel emit: bit lengths -> exclusive scan -> absolute
bit offsets; each element's masked code lands in at most two 32-bit
words, and the contributions within a word are bit-disjoint, so a word
is the difference of a running sum of contributions taken at the first
element of that word and of the next one.  The reference is XLA code,
not a Pallas kernel; this is plain torch.  :func:`pack_bits_device` is
the generic packer of the reference's fixed-Huffman device step
(``ops/pipeline.py``) on the same machinery.

The running sums run in int64 with no wraparound (each contribution is
< 2^32), so the differences are the exact per-word sums the reference
gets mod 2^32.  Words come back as int64 holding uint32 values.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def _mask_vals(v, nb):
    """Low ``nb`` bits of ``v``, as int64."""
    nb = nb.to(torch.int64)
    return v.to(torch.int64) & ((torch.ones_like(nb) << nb) - 1)


def _split_words(masked, offsets):
    """(lo, hi): a value's bits landing in word offsets >> 5 and the next."""
    r = offsets & 31
    lo = (masked << r) & _M32
    hi = torch.where(r == 0, 0, masked >> ((32 - r) & 31))
    return lo, hi


def _invert_offsets_b(widx, out_words: int):
    """F[b, w] = first element whose (monotone) word index reaches w, for
    w in [0, out_words]; elements past the last word clamp into
    F[:, out_words].  One scatter-min + reverse cummin."""
    b, n = widx.shape
    ranks = torch.arange(n, device=widx.device).expand(b, n)
    f0 = torch.full((b, out_words + 1), n, dtype=torch.int64,
                    device=widx.device)
    f0.scatter_reduce_(1, torch.clamp(widx, max=out_words), ranks, "amin",
                       include_self=True)
    return torch.flip(torch.cummin(torch.flip(f0, (1,)), 1).values, (1,))


def _plane_words_b(masked, offsets, out_words: int):
    """Word image [B, out_words] of one monotone plane [B, N]."""
    lo, hi = _split_words(masked, offsets)
    f = _invert_offsets_b(offsets >> 5, out_words)
    z = torch.zeros_like(lo[:, :1])
    el = torch.cat([z, torch.cumsum(lo, 1)], 1)
    eh = torch.cat([z, torch.cumsum(hi, 1)], 1)
    gl = torch.gather(el, 1, f)
    gh = torch.gather(eh, 1, f)
    out_lo = gl[:, 1:] - gl[:, :-1]
    dh = gh[:, 1:] - gh[:, :-1]
    # hi parts land one word later: word w collects hi of widx == w-1
    return out_lo + torch.cat([z, dh[:, :-1]], 1)


def _scatter_tiny(masked, offsets, out_words: int):
    """Direct two-word scatter for a tiny plane [B, H] (headers, EOB);
    contributions past the last word are dropped."""
    lo, hi = _split_words(masked, offsets)
    widx = offsets >> 5
    out = torch.zeros((masked.shape[0], out_words), dtype=torch.int64,
                      device=masked.device)
    for idx, val in ((widx, lo), (widx + 1, hi)):
        keep = idx < out_words
        out.scatter_add_(1, torch.where(keep, idx, 0), torch.where(keep, val, 0))
    return out


def pack_slot_planes(v0, n0, v1, n1, hdr_vals, hdr_bits, eob_vals, eob_bits,
                     out_words: int):
    """Pack slot 0 then slot 1 of every position after the header bits,
    with the EOB code appended.

    v0/n0/v1/n1: int[B, T]; hdr_vals/hdr_bits [B, H]; eob_vals/eob_bits
    [B, 1].  Returns (words int64[B, out_words] holding uint32 values,
    total_bits int64[B], off0 int64[B, T], posbits int64[B, T])."""
    hdr_bits = hdr_bits.to(torch.int64)
    hdr_off = torch.cumsum(hdr_bits, 1) - hdr_bits
    hdr_total = hdr_off[:, -1:] + hdr_bits[:, -1:]
    posbits = n0.to(torch.int64) + n1.to(torch.int64)
    off0 = hdr_total + torch.cumsum(posbits, 1) - posbits
    off1 = off0 + n0
    eob_off = off0[:, -1:] + posbits[:, -1:]
    total = (eob_off + eob_bits)[:, 0]
    words = _plane_words_b(_mask_vals(v0, n0), off0, out_words)
    words = words + _plane_words_b(_mask_vals(v1, n1), off1, out_words)
    tv = torch.cat([hdr_vals.to(torch.int64), eob_vals.to(torch.int64)], 1)
    tn = torch.cat([hdr_bits, eob_bits.to(torch.int64)], 1)
    toff = torch.cat([hdr_off, eob_off], 1)
    words = words + _scatter_tiny(_mask_vals(tv, tn), toff, out_words)
    return words & _M32, total, off0, posbits


def pack_bits_device(values, nbits, out_words: int):
    """Pack ``values`` (the low ``nbits`` of each, 0..31) LSB-first, on
    their device; counterpart of the reference's ``pack_bits_device``.

    values: int[..., N]; nbits: int[..., N] (leading dims are batch).
    Returns ``(words uint32[..., out_words], total_bits int32[...])``.
    Elements whose offset lies past ``32 * out_words`` bits are dropped.
    Elements with ``nbits == 0`` add nothing."""
    lead = values.shape[:-1]
    v = values.reshape(-1, values.shape[-1])
    nb = nbits.reshape(-1, nbits.shape[-1]).to(torch.int64)
    offsets = torch.cumsum(nb, 1) - nb
    total = offsets[:, -1] + nb[:, -1]
    words = _plane_words_b(_mask_vals(v, nb), offsets, out_words) & _M32
    # uint32 from the int64 words, by way of their two's-complement int32
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    words = words.to(torch.int32).view(torch.uint32)
    return (words.reshape(*lead, out_words),
            total.to(torch.int32).reshape(lead))


def words_to_bytes(words, total_bits: int) -> bytes:
    """uint32 words (a tensor or an array) -> the first
    ceil(total_bits / 8) bytes of the stream, on the host."""
    if isinstance(words, torch.Tensor):
        words = words.cpu().view(torch.int32).numpy()
    b = np.ascontiguousarray(words).astype("<u4", copy=False).view(np.uint8)
    return b[: (int(total_bits) + 7) // 8].tobytes()
