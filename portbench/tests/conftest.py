"""The benchmark's own tests: on the CPU, at small sizes.  A test that needs
the card is marked `cuda` and decides inside a fixture."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")
