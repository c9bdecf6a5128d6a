r"""Tests of the port's benchmark: ``python -m pytest portbench/tests -q``
from the repository's root (the card test: ``-m cuda`` on the card)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips inside the test when "
        "torch.cuda.is_available() is False")


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
