"""pytest settings of the benchmark's own tests (portbench/tests/): the
marker of tests that need the card, and the fixture that decides it."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU with CUDA; skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, when
    the test runs, never while modules are imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda"
