"""Host-side DEFLATE constants, Huffman and bitstream machinery: copies of
``decompress_tpu/core`` (JAX-free numpy), kept equal by
``tests/test_torch_core.py``."""

from . import bitstream, huffman, tables  # noqa: F401
