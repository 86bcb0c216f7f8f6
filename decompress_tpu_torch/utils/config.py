"""Framework configuration (counterpart of ``decompress_tpu/utils/config.py``).

Every knob of the codecs is a function argument (level 0-12, window bits
8-15, queue size, buffer size, ``dynamic``); this dataclass carries them,
and the device-side ones (segment and batch geometry, mesh axis, archive
indexing, the device), in one object.  ``de.deflate`` and
``parallel.sharded_gzip_compress`` take it as ``config=``; an explicit
argument wins over the config.  The reference's JAX ``platform`` field is
``device`` here.

Read: ``level``, ``window_bits``, ``dynamic_blocks``, ``segment_size`` and
``device`` by ``de.deflate``; ``level``, ``member_size``, ``write_index``,
``shared_tree`` and ``device`` by ``sharded_gzip_compress``.  Accepted and
ignored, kept only so that a reference config carries over field for field:
``queue_capacity`` (checked by ``validate()``, used by nothing),
``io_buffer_size``, ``device_batch`` and ``mesh_axis``.  The reference reads
none of these four either.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CodecConfig:
    # codec knobs
    level: int = 6                 # 0 stored … 9 max effort; 10-12 extra effort
    window_bits: int = 15          # 8..15
    queue_capacity: int = 4096     # command ring size
    io_buffer_size: int = 65536
    dynamic_blocks: bool = True    # dynamic Huffman blocks allowed

    # device-side knobs
    segment_size: int | None = None   # device segment payload (de.SEGMENT_SIZE)
    device_batch: int | None = None   # segments per device call
    member_size: int | None = None    # sharded gzip member payload
    write_index: bool = True          # FEXTRA member index for parallel decode
    shared_tree: bool = False         # one dynamic tree from the summed frequencies
    mesh_axis: str = "dp"
    device: str = "cuda"              # "cuda" or "cpu"

    def validate(self) -> "CodecConfig":
        if not 0 <= self.level <= 12:
            raise ValueError("level must be in 0..12")
        if not 8 <= self.window_bits <= 15:
            raise ValueError("window bits must be in 8..15")
        if self.queue_capacity & (self.queue_capacity - 1):
            raise ValueError("queue capacity must be a power of two")
        return self


DEFAULT_CONFIG = CodecConfig()
