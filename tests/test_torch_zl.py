"""zlib framing: the port's ``zl`` against the reference's.

``decompress_tpu_torch.zl.deflate(..., device="cpu")`` (the plain
PyTorch versions of the kernels) against ``decompress_tpu.zl.deflate``
(JAX on the CPU), byte for byte, at levels 0, 1, 4, 6 and 9, with
``window_bits`` 9 and 15, a preset dictionary, fixed blocks and a
strategy; ``zlib.decompress`` restores each.  ``zl.inflate_ex`` against
the reference's (pinned to its pure-Python decoder, ``tests/ref_host.py``)
on the port's and on stdlib streams, with trailing bytes: payload and
bytes consumed equal.  The malformed inputs of ``tests/test_formats.py``
and more: the same exception class and message.
"""

import pathlib
import zlib

import pytest

from decompress_tpu import zl as ref_zl
from decompress_tpu_torch import de, zl
from ref_host import ref_host  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

CORPUS = pathlib.Path(__file__).parent / "corpus"
SEG = 4096
X = (CORPUS / "paper1").read_bytes()[:12_000]
ZDICT = (CORPUS / "paper2").read_bytes()[:4000]


def _outcome(fn, *args, **kw):
    """fn's result, or the raised exception's module, class and message."""
    try:
        return fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 - the exception is the result
        return (type(e).__module__.rsplit(".", 1)[-1], type(e).__name__, str(e))


@pytest.mark.parametrize("kw", [
    dict(level=0), dict(level=1), dict(level=4), dict(level=6), dict(level=9),
    dict(level=6, window_bits=9), dict(level=4, window_bits=15),
    dict(level=6, zdict=ZDICT), dict(level=4, dynamic=False),
    dict(level=4, strategy="huffman_only"),
], ids=["l0", "l1", "l4", "l6", "l9", "wbits9", "wbits15", "zdict", "fixed",
        "huffman_only"])
def test_deflate_matches_reference(kw):
    want = ref_zl.deflate(X, segment_size=SEG, **kw)
    got = zl.deflate(X, segment_size=SEG, device="cpu", **kw)
    assert got == want
    d = zlib.decompressobj(zdict=kw["zdict"]) if "zdict" in kw else zlib.decompressobj()
    assert d.decompress(got) == X and d.eof
    assert zl.inflate(got, zdict=kw.get("zdict")) == X


def test_header_fields_and_empty_match_reference():
    for level in (0, 1, 2, 5, 6, 7, 12):
        assert zl._flevel(level) == ref_zl._flevel(level)
        assert zl.deflate(b"", level, device="cpu") == ref_zl.deflate(b"", level)
    assert zl.compress is zl.deflate and zl.uncompress is zl.inflate
    assert issubclass(zl.MalformedError, de.MalformedError)


def _stdlib(level=6, wbits=15, zdict=None):
    c = zlib.compressobj(level, zlib.DEFLATED, wbits, 9, 0, *((zdict,) if zdict else ()))
    return c.compress(X) + c.flush()


@pytest.mark.parametrize("which", ["port", "stdlib6", "stdlib1_wbits9", "stdlib_zdict"])
def test_inflate_ex_matches_reference(ref_host, which):
    zdict = ZDICT if which == "stdlib_zdict" else None
    stream = {"port": lambda: zl.deflate(X, segment_size=SEG, device="cpu"),
              "stdlib6": _stdlib,
              "stdlib1_wbits9": lambda: _stdlib(1, 9),
              "stdlib_zdict": lambda: _stdlib(zdict=ZDICT)}[which]()
    got = zl.inflate_ex(stream + b"next member", zdict=zdict)
    assert got == (X, len(stream))
    assert got == ref_zl.inflate_ex(stream + b"next member", zdict=zdict)


def _malformed():
    good = zlib.compress(X[:3000], 6)
    fdict = _stdlib(zdict=ZDICT)
    bad_adler = bytearray(good)
    bad_adler[-1] ^= 0xFF
    bad_body = bytearray(good)
    bad_body[2] |= 0b110  # the first block's type set to the reserved 3
    return {
        "header_checksum": b"\x78\x00" + b"\x03\x00" + b"\x00" * 4,
        "adler": bytes(bad_adler),
        "truncated_trailer": good[:-2],
        "truncated_body": good[:40],
        "short_header": b"\x78",
        "kind_of_flow": bytes([0x79, (31 - (0x79 * 256) % 31) % 31]) + good[2:],
        "window": bytes([0x88, (31 - (0x88 * 256) % 31) % 31]) + good[2:],
        "reserved_block": bytes(bad_body),
        "dict_missing": fdict,
        "dict_wrong": fdict,
        "dict_truncated": fdict[:4],
    }


MALFORMED = _malformed()


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_matches_reference(ref_host, name):
    zdict = {"dict_wrong": b"wrong dictionary", "dict_truncated": ZDICT}.get(name)
    want = _outcome(ref_zl.inflate, MALFORMED[name], zdict=zdict)
    assert want[1] == "MalformedError", want
    assert _outcome(zl.inflate, MALFORMED[name], zdict=zdict) == want
