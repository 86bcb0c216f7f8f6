"""Tests of the benchmark: ``python -m pytest benchmark/tests``."""
