"""Tests of the benchmark. They run on the CPU in seconds to a minute each;
those marked ``card`` need a CUDA card and skip without one:

    python3 -m pytest zkbench/tests -q              # here, on the CPU
    python3 -m pytest zkbench/tests -q -m card      # on the card
"""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The card the test runs on; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's runs are the card's")
    return torch.device("cuda:0")
