"""decompress_tpu_torch — the PyTorch/CUDA port of decompress_tpu.

One-shot and streaming DEFLATE, zlib and gzip compression at levels 0-12
(default 6), the member-parallel gzip archive (indexed write and decode)
and zlib stream, on an NVIDIA Hopper card, byte-identical to the JAX
package ``decompress_tpu`` (the reference); and the one-shot and
streaming decode of DEFLATE, zlib and gzip streams on the host, as the
reference decodes them.  The device work is torch code around seven
hand-written CUDA kernels (``csrc/``): mark path, histograms, literal
bits, match gains, slot build, symbol decode and CRC-32.  Every kernel
wrapper takes its plain PyTorch version for a CPU tensor and launches the
kernel for a CUDA tensor.

Layout mirrors the reference: ``gz``/``zl`` -> ``streaming`` (the
resumable codecs: ``Inflate``, ``Deflate``, the ``Lz77`` match finder, the
queue-driven ``Def`` encoder) -> ``de`` -> ``ops`` (``lz77``,
``bitpack``, ``codes``, ``inflate``, ``checksum`` and the kernel wrappers
``parse_cu``, ``hist_cu``, ``cost_cu``, ``pack_cu``, ``inflate_cu``,
``crc_cu``), ``parallel.sharded`` for the archive and the zlib stream,
``core`` for the host tables, Huffman and bitstream code, ``lz`` for the
standalone host matcher, ``native`` for the host runtime (a copy of the
reference's C++ inflater, checksums and LZO, built with ``g++`` at first
use), with ``_build`` compiling the kernels at first use.  This package
imports neither JAX nor the reference package.
"""

__version__ = "0.1.0"
