"""pytest settings of the benchmark's own tests (perfbench/tests/): the
repository root on the import path, and the ``card`` marker of tests that
need a CUDA card, which skip elsewhere (decided in the ``card`` fixture,
never at import)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    """The card's device name; skips the test where there is no card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is "
                    "False)")
    return "cuda"
