"""The benchmark's own tests: ``python -m pytest perfbench/tests`` from the
root of the repository (CPU), and with a card ``python -m pytest
perfbench/tests -m chip`` runs the control at the cells' own sizes.
Tests marked ``chip`` decide in a fixture whether there is a card and
skip without one."""
import os
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA H100; skips where CUDA is absent")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the H100); this machine has none")
    return torch.device("cuda")
