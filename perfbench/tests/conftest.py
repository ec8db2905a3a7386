"""The benchmark's own tests: on the CPU at SF 0.01.  Tests that need a
CUDA device are marked ``cuda`` and skip without one."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    import torch

    # several test workers share the host's cores
    torch.set_num_threads(2)
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skipped where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")
