"""Tests of the benchmark (``python -m pytest benchmark/tests``).  Tests
marked ``cuda`` need a card and skip without one."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips without one")
