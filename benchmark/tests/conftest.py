"""Tests of the benchmark (``python -m pytest benchmark/tests``): the
generator, the reference, the harness, the control and the faults on the
CPU at toy sizes; one toy run on a CUDA card (marked ``cuda``)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips with a reason elsewhere"
    )


@pytest.fixture
def cuda_card():
    """Skips unless a CUDA card is there (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return "cuda"
