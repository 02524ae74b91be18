"""CPU tests of the benchmark (``python -m pytest retrieval_bench/tests``
from the checkout's root). Tests marked ``cuda`` need the card and decide
inside the test."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture(autouse=True, scope="session")
def _threads():
    torch.set_num_threads(4)
