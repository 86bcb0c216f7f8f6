"""Per-file gzip at the port's shapes: one ``gz.compress`` per file, as
``gzip -6 FILE...`` writes one member per file.  Files of 1 to 6
segments fill one batch each, padded to 1, 2, 4 or 8 rows; each output
equals the reference's bytes, zlib decodes it, and ``de.BATCH_COUNTS``
counts the batch, its rows, its valid rows and its payload."""

import collections
import pathlib
import zlib

import pytest

from decompress_tpu import gz as ref_gz
from decompress_tpu_torch import de, gz

from torch_threads import one_torch_thread  # noqa: F401

CORPUS = pathlib.Path(__file__).parent / "corpus"
SEG = 4096


@pytest.mark.parametrize("n,rows", [
    (900, 1),                # under a quarter segment, as obj1 in a 130,560-byte row
    (SEG - 96, 1),
    (SEG + 2000, 2),
    (2 * SEG + 3000, 4),
    (4 * SEG + 100, 8),
    (6 * SEG, 8),            # six whole segments, no short tail
])
def test_one_file_one_batch(n, rows):
    x = ((CORPUS / "paper1").read_bytes() + (CORPUS / "obj2").read_bytes())[:n]
    nseg = -(-n // SEG)
    before = collections.Counter(de.BATCH_COUNTS)
    got = gz.compress(x, 6, segment_size=SEG, device="cpu")
    counts = de.BATCH_COUNTS - before
    assert got == ref_gz.compress(x, 6, segment_size=SEG)
    assert zlib.decompress(got, 31) == x
    assert counts == {"batches": 1, "rows": rows, "valid_rows": nseg, "payload_bytes": n,
                      "row_bytes": rows * SEG}
