"""Found by name from ``BENCHMARK.json`` (``benchmark/spec.py``)."""
