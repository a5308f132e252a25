"""CPU tests of the benchmark; run them with ``python3 -m pytest benchmark/tests``.
Tests that need a CUDA card carry the ``card`` marker and take the ``card``
fixture, which skips them where there is none."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: this test runs on the chip")


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(threads)
