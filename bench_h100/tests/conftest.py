"""CPU tests of the benchmark's harness: ``python -m pytest bench_h100/tests``
from the root of the repository. They need no card: the kinds run on the
CPU at a tiny size, where the program takes its kernels' plain versions."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 4))
    yield
    torch.set_num_threads(before)
