"""Tests of the benchmark's harness, on the CPU.

Run from the repository's root: ``python -m pytest benchmark/tests -q``.
A test that needs the card is marked ``cuda`` and skips without one; the
decision is made inside the ``cuda_device`` fixture, never at import.
"""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with CUDA; skipped without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the cell's kernels are CUDA kernels")
    return torch.device("cuda")
