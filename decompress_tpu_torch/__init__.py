"""decompress_tpu_torch — the PyTorch/CUDA port of decompress_tpu.

One-shot and streaming DEFLATE, zlib and gzip compression at levels 0-12
(default 6), LZO1X, the member-parallel gzip archive (indexed write and
decode, over a mesh of devices or several processes) and zlib stream, on
an NVIDIA Hopper card, byte-identical to the JAX package
``decompress_tpu`` (the reference); the one-shot and streaming decode of
DEFLATE, zlib, gzip and LZO streams on the host, as the reference decodes
them; and a command line (``python -m decompress_tpu_torch.cli``).  The device work is torch code around seven
hand-written CUDA kernels (``csrc/``): mark path, histograms, literal
bits, match gains, slot build, symbol decode and CRC-32.  Every kernel
wrapper takes its plain PyTorch version for a CPU tensor and launches the
kernel for a CUDA tensor.

Layout mirrors the reference: ``cli``; ``gz``/``zl``/``lzo`` -> ``streaming`` (the
resumable codecs: ``Inflate``, ``Deflate``, the ``Lz77`` match finder, the
queue-driven ``Def`` encoder) -> ``de`` -> ``ops`` (``lz77``,
``bitpack``, ``codes``, ``inflate``, ``checksum`` and the kernel wrappers
``parse_cu``, ``hist_cu``, ``cost_cu``, ``pack_cu``, ``inflate_cu``,
``crc_cu``, and ``pipeline``, the fixed-Huffman step), ``parallel``
(``sharded``: meshes, the archive and the zlib stream; ``multihost``: the
archive across processes), ``utils`` (``CodecConfig``, profiling),
``core`` for the host tables, Huffman and bitstream code, ``lz`` for the
standalone host matcher, ``native`` for the host runtime (a copy of the
reference's C++ inflater, checksums and LZO, built with ``g++`` at first
use), with ``_build`` compiling the kernels at first use.  ``rfc1951``
is an alias of ``de``, as in the reference.  This package imports neither
JAX nor the reference package.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # `rfc1951` is an alias of `de`, as the reference ships de twice
    if name == "rfc1951":
        from . import de

        return de
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
