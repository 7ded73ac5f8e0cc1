"""The benchmark's own tests: ``python -m pytest lutvq_bench/tests`` from the
checkout's root.  Tests that need a CUDA card are marked ``cuda`` and skip
inside the test where there is none."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skipped without one)")
    import torch

    # one thread, as a run has (``run.py``): a window's ticks then depend
    # little on what else the machine runs
    torch.set_num_threads(1)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, in the
    test's own process, never while modules are imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
