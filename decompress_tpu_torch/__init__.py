"""decompress_tpu_torch — the PyTorch/CUDA port of decompress_tpu.

One-shot DEFLATE and gzip compression at levels 0-12 (default 6), and the
member-parallel gzip archive (indexed write and decode), on an NVIDIA
Hopper card, byte-identical to the JAX package ``decompress_tpu`` (the
reference).  The device work is torch code around seven hand-written
CUDA kernels (``csrc/``): mark path, histograms, literal bits, match
gains, slot build, symbol decode and CRC-32 chunk registers.  Every kernel
wrapper takes its plain PyTorch version for a CPU tensor and launches the
kernel for a CUDA tensor.

Layout mirrors the reference: ``gz`` -> ``de`` -> ``ops`` (``lz77``,
``bitpack``, ``codes``, ``inflate``, ``checksum`` and the kernel wrappers
``parse_cu``, ``hist_cu``, ``cost_cu``, ``pack_cu``, ``inflate_cu``,
``crc_cu``), ``parallel.sharded`` for the archive, ``core`` for the
host tables, Huffman and bitstream code, with ``_build`` compiling the
kernels at first use.  This package imports neither JAX nor the
reference package.
"""

__version__ = "0.1.0"
