"""Tests of the benchmark harness. They need no card, nvcc or triton: the
port runs its plain versions on the host at small sizes. A test that needs
the card is marked ``card`` and skips where there is none.

    python -m pytest benchmark/tests -q
"""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")
