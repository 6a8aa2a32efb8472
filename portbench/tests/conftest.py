"""Tests of the benchmark harness: ``python -m pytest portbench/tests -q``
(CPU, about two minutes). Tests marked ``chip`` need a CUDA card and skip
without one; on the card: ``python -m pytest portbench/tests -q -m chip``."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skips without one)")
