"""Pin the reference's host decode to its pure-Python path.

The reference (``decompress_tpu``) runs its one-shot decode through its
native library when that loads, and through its pure-Python decoder
otherwise; the two agree by design (``tests/test_fixtures.py``).  Its
native library builds in place at first use, unguarded across
processes, so the port's parity tests do not load it: the ``ref_host``
fixture makes the reference see no native library, and gives its host
framing checksums their standard values (``zlib.crc32``,
``zlib.adler32``), which its native checksums return.
"""

import zlib

import pytest

from decompress_tpu import gz as ref_gz
from decompress_tpu import native as ref_native


@pytest.fixture
def ref_host(monkeypatch):
    monkeypatch.setattr(ref_native, "available", lambda: False)
    host = type(ref_gz.checksum)
    monkeypatch.setattr(host, "crc32", staticmethod(zlib.crc32))
    monkeypatch.setattr(host, "adler32", staticmethod(zlib.adler32))
