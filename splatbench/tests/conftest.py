"""Settings of the benchmark's own tests (``python -m pytest
splatbench/tests``): the ``cuda`` marker, and a checkout root on the
import path."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped without one")
