"""Pytest settings of the benchmark's own tests (`python -m pytest
benchmark/tests`): the repository's root on the path, and the `card`
marker of the tests that need an NVIDIA GPU, which skip elsewhere."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU (CUDA); skips without one")


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none (decided when
    the test runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: this machine has no CUDA device")
    return torch.device("cuda", 0)
