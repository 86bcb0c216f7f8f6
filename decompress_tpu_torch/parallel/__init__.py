"""Device meshes, the member-parallel gzip archive and zlib stream, the
fixed-Huffman step over a mesh, and the multi-process archive
(counterpart of ``decompress_tpu/parallel``)."""

from .sharded import (  # noqa: F401
    make_mesh,
    sharded_gzip_compress,
    sharded_gzip_decompress,
    sharded_zlib_compress,
    compress_step_sharded,
)
