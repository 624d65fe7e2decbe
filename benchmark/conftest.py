"""pytest settings of the benchmark's own tests (``python -m pytest
benchmark/tests -q``, from the repository root)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips on a machine without one")


@pytest.fixture
def card():
    """The first CUDA card; the test skips without one.  Decided here, in
    the fixture, never while a module is imported."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)
