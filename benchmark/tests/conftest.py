"""The benchmark's tests run from the root of the checkout, which holds
both ``benchmark`` and ``workloads_torch``."""

import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda_card():
    """Skips a card test where there is no CUDA card (decided here, never
    while the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, int(os.environ.get("BENCH_TEST_THREADS", "1"))))
    yield
    torch.set_num_threads(threads)
