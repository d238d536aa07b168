"""CPU tests of the benchmark; ``card`` tests run only where a CUDA card
is, and skip here with the reason."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """Skip the test unless a CUDA card is visible (decided at the call,
    never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip with "
                    "python3 -m pytest benchmark/tests -m card")
    return torch.device("cuda", 0)
