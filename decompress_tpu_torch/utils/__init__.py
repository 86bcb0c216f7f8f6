"""Configuration and profiling helpers (counterpart of
``decompress_tpu/utils``; the reference's XLA compile cache has no
counterpart: the kernel library is cached by ``_build``)."""
