"""The member-parallel gzip archive and zlib stream (counterpart of
``decompress_tpu/parallel``, one device)."""

from .sharded import (  # noqa: F401
    sharded_gzip_compress,
    sharded_gzip_decompress,
    sharded_zlib_compress,
)
