"""Tests of the benchmark: CPU tests at small sizes; tests marked ``cuda``
need the card and skip without one (decided in a fixture, never at
import)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def pytest_configure(config):
    # Small tensors and several xdist workers: one thread a worker.
    import torch

    torch.set_num_threads(1)
