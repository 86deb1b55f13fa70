"""Tests of the benchmark. They run on the CPU at tiny sizes, through the
program's plain paths; a test that needs the card carries the ``cuda``
marker and decides inside the test."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
