"""Fixtures of the benchmark's tests: the harness on the import path, the
card's fill path on the CPU, and the card's presence decided in a fixture
(never while a module is imported)."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


@pytest.fixture(autouse=True)
def direct_fill(monkeypatch):
    """The card's fill path (the direct determinant fill) on the CPU too,
    and torch on one thread (several test workers share the cores)."""
    import torch

    monkeypatch.setenv("TEMFPY_TORCH_DET_UPDATES", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """Skips a test that needs an NVIDIA card where torch sees none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")
