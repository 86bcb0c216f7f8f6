"""The benchmark of ``decompress_tpu_torch`` on the card: ``python3 benchmark/run.py --help``."""
