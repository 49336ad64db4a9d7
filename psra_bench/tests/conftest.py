"""Markers of the benchmark's own tests (run them with
``python -m pytest psra_bench/tests`` from the repository's root)."""
import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided when the test
    runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card in this process")
    return torch.device("cuda")
