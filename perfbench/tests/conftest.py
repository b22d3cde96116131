"""CPU tests of the benchmark (python -m pytest perfbench/tests). The
repository root goes on sys.path so that `perfbench` and the program
import as packages; torch keeps to one thread on a shared box."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
