"""The benchmark's own tests, run on the CPU from the checkout's root:

    python3 -m pytest benchmark/tests -q

They put the benchmark folder and the checkout's root on the path as
``benchmark/run.py`` does. A test that needs a CUDA card takes the
``card`` fixture, which skips it on a machine without one."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
