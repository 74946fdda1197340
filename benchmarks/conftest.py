"""pytest settings of the benchmark's own tests (``pytest benchmarks/tests``).

Tests marked ``card`` need a CUDA device: they take the ``card`` fixture,
which decides at run time, never at import, and skips with a reason where
there is none. Run them on the card with
``python3 -m pytest benchmarks/tests -m card``.
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; this machine has none")
    return "cuda"
