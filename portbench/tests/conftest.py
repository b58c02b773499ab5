"""The benchmark's own tests. ``pytest portbench/tests`` runs them on the
CPU; tests marked ``chip`` need a CUDA device and skip without one (the
decision is made in the ``cuda_device`` fixture, never at import)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device (run on the chip)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the chip")
    return torch.device("cuda")
