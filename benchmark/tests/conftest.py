"""Tests of the benchmark (run by hand: `python -m pytest benchmark/tests -q`).
They run the cells at a tiny size on the CPU, where the port runs its kernels'
plain versions; tests marked `cuda` need a card and skip without one."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped without one")
