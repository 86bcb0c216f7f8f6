"""decompress_tpu_torch — the PyTorch/CUDA port of decompress_tpu.

One-shot DEFLATE and gzip compression at levels 0-12 (default 6) on an
NVIDIA Hopper card, byte-identical to the JAX package ``decompress_tpu``
(the reference).  The device work is torch code around five hand-written
CUDA kernels (``csrc/``): mark path, histograms, literal bits, match
gains and slot build.  Every kernel wrapper takes its plain PyTorch
version for a CPU tensor and launches the kernel for a CUDA tensor.

Layout mirrors the reference: ``gz`` -> ``de`` -> ``ops`` (``lz77``,
``bitpack``, ``codes`` and the kernel wrappers ``parse_cu``, ``hist_cu``,
``cost_cu``, ``pack_cu``), with ``_build`` compiling the kernels at
first use.  This
package imports no JAX.
"""

__version__ = "0.1.0"
