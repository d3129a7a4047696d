"""The benchmark's own tests: `python -m pytest portbench/tests -q`.

Tests marked `card` need a CUDA card; they decide in the `card` fixture,
at run time, and skip here with the reason."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card: python -m pytest "
                    "portbench/tests -q -m card")
    return "cuda"
