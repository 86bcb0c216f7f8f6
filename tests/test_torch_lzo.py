"""The port's LZO1X codec (``decompress_tpu_torch.lzo``, match finding by
the plain PyTorch versions of the kernels on the CPU) against the
reference's (``decompress_tpu.lzo``, JAX on the CPU).

* ``compress`` bytes equal the reference's at levels 1, 4, 6 and 9 on the
  small corpus files, at levels 1, 4 and 6 on the patterns of
  ``tests/test_lzo.py`` (level 9 costs 2.6 s a call on the CPU, whatever
  the input's size: every call analyses a whole segment; its analysis is
  held equal in ``tests/test_torch_pipeline.py``), and at level 6 on
  300,000 bytes of the corpus (three segments, history from the previous
  segment); each decodes back with both decoders;
* LZO's analysis and ``de.match_commands_batch`` upload through
  ``transfer.upload`` and read each batch through one Fetch;
* the golden literal-only stream and the end-marker-only stream;
* malformed input raises ``LzoError`` with the reference's message, from
  the native decoder and from the host state machine;
* ``uncompress_into``, ``uncompress_with_buffer`` and ``make_wrkmem``;
* the independent minilzo-2.10 oracle decodes the port's streams, and the
  port decodes minilzo's (skipped without a C compiler, as
  ``tests/test_lzo_minilzo.py`` is).
"""

import pathlib

import numpy as np
import pytest
import torch

from decompress_tpu import de as ref_de
from decompress_tpu import lzo as ref
from decompress_tpu_torch import de, lzo
from decompress_tpu_torch.ops import lz77, transfer
from torch_threads import one_torch_thread  # noqa: F401

import minilzo_oracle

CORPUS = pathlib.Path(__file__).parent / "corpus"


def _patterns():
    """The inputs of tests/test_lzo.py's round trips."""
    rng = np.random.default_rng(1)
    return [b"Salut les copains!", b"a", b"ab", b"abc", b"aaaa", b"a" * 40,
            b"\x00" * 10000, b"abcabcabc" * 1000, b"x" * 239, b"x" * 238,
            rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
            b"hello world " * 500 + rng.integers(0, 256, 3000, np.uint8).tobytes()]


def _same(data: bytes, level: int) -> bytes:
    got = lzo.compress(data, level=level, device="cpu")
    assert got == ref.compress(data, level=level)
    assert lzo.uncompress(got) == data
    assert lzo.uncompress_with_buffer(got) == data
    return got


@pytest.mark.parametrize("level", [1, 4, 6, 9])
def test_compress_matches_reference_corpus(small_corpus, level):
    for name, data in small_corpus:
        assert len(_same(data, level)) < len(data), name


@pytest.mark.parametrize("level", [1, 4, 6])
def test_compress_matches_reference_patterns(level):
    for data in _patterns():
        _same(data, level)


def test_compress_matches_reference_across_segments():
    base = b"".join(p.read_bytes() for p in sorted(CORPUS.iterdir()))
    _same(base[:300_000], 6)


def test_lzo_and_queue_engine_stage_through_transfer(monkeypatch):
    """LZO's analysis and the queue engine's match finder stage their rows
    with ``transfer.upload`` (rows, the first row's history where rows
    chain, valid and history lengths) and read each batch's parse fields
    through one Fetch; their bytes and commands are the reference's."""
    uploads, fetches = [], []
    upload, fetch = transfer.upload, transfer.Fetch

    def counted(a, device, keep=None):
        uploads.append(a.shape)
        return upload(a, device, keep)

    class Counted(fetch):
        def __init__(self, tensors):
            fetches.append(sorted(tensors))
            super().__init__(tensors)

    monkeypatch.setattr(transfer, "upload", counted)
    monkeypatch.setattr(transfer, "Fetch", Counted)
    fields = sorted(["on_path", "is_match", "length", "dist"])
    base = b"".join(p.read_bytes() for p in sorted(CORPUS.iterdir()))
    _same(base[:20_000], 6)
    assert uploads == [(1, de.SEGMENT_SIZE), (lz77.HIST,), (1,), (1,)]
    assert fetches.count(fields) == 1

    uploads.clear()
    fetches.clear()
    chunks = [base[50000:54096], base[54096:58192], base[70000:71000]]
    hists = [base[50000 - 10000:50000], base[54096 - 40000:54096], b""]
    got = de.match_commands_batch(chunks, hists, 6, seg=4096, device="cpu")
    for g, w in zip(got, ref_de.match_commands_batch(chunks, hists, 6, seg=4096),
                    strict=True):
        np.testing.assert_array_equal(g, w)
    assert uploads[:3] == [(4, lz77.HIST + 4096), (4,), (4,)]
    assert fetches.count(fields) == 1


def test_golden_streams():
    rng = np.random.default_rng(9)
    payload = rng.integers(0, 256, 128, dtype=np.uint8).tobytes()
    stream = bytes([0x91]) + payload + bytes([0x11, 0x00, 0x00])
    assert lzo.uncompress(stream) == ref.uncompress(stream) == payload
    assert lzo._uncompress_python(stream) == payload
    assert lzo.uncompress(bytes([0x11, 0x00, 0x00])) == b""
    assert lzo.compress(b"", device="cpu") == ref.compress(b"") == bytes([0x11, 0x00, 0x00])


_MALFORMED = [b"", bytes([0x91]), bytes([0x12, 0x01, 0x00, 0x00]),
              bytes([0x00, 0x00, 0x11, 0x00, 0x00]), bytes([0x11, 0x00]),
              bytes([0x14, 0x61, 0x62, 0x63, 0x11, 0x00, 0x00, 0x99]),
              bytes([0x00]) + b"\x00" * 70000]


def _error(fn, data):
    with pytest.raises(ValueError) as e:
        fn(data)
    return type(e.value).__name__, str(e.value)


@pytest.mark.parametrize("idx", range(len(_MALFORMED)))
def test_malformed_matches_reference(idx):
    data = _MALFORMED[idx]
    got = _error(lzo.uncompress, data)
    assert got[0] == "LzoError"
    assert got == _error(ref.uncompress, data)
    assert _error(lzo._uncompress_python, data) == _error(ref._uncompress_python, data)
    assert _error(lzo.uncompress_with_buffer, data) == \
        _error(ref.uncompress_with_buffer, data)


def test_buffers_and_wrkmem():
    data = b"growable output " * 100
    comp = lzo.compress(data, device="cpu")
    assert lzo.uncompress_with_buffer(comp) == data
    out = np.zeros(len(data) + 7, np.uint8)
    assert lzo.uncompress_into(comp, out) == len(data)
    assert out[: len(data)].tobytes() == data
    with pytest.raises(lzo.LzoError, match="failed"):
        lzo.uncompress_into(comp, np.zeros(10, np.uint8))
    wm = lzo.make_wrkmem()
    assert isinstance(wm, lzo.WrkMem) and len(wm.scratch) == len(ref.make_wrkmem().scratch)
    assert lzo.compress(b"data data data", wm, device="cpu") == ref.compress(b"data data data")


def test_compress_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        lzo.compress(b"no card here")


def test_minilzo_cross_check():
    if minilzo_oracle.load() is None:
        pytest.skip("no C compiler for minilzo oracle")
    base = (CORPUS / "progc").read_bytes()
    for data in [base, b"a" * 5000, (b"abc" * 30000)[:65536], b"\x00"]:
        comp = lzo.compress(data, device="cpu")
        assert minilzo_oracle.decompress(comp, len(data) + 16) == data
        mcomp = minilzo_oracle.compress(data)
        assert lzo.uncompress(mcomp, max_size=len(data) + 16) == data
        assert lzo.uncompress_with_buffer(mcomp) == data
