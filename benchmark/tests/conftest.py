"""The benchmark's own tests: the harness, the yardstick's arithmetic,
the traffic generator and the checks that decide `correct`, on the CPU
at tiny sizes. Run from the repository's root:

    python -m pytest benchmark/tests -q

Tests that need a card carry the `cuda` marker and skip without one."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; decides inside the test")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
