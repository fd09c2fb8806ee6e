"""The benchmark's CPU tests: the checkout's root (for ``perfbench``) and
``src`` (for the port, which some tests compare with) on the path.  A
test that needs the card is marked ``cuda`` and skips here, deciding in
the ``cuda_device`` fixture."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device")
    # one thread, as perfbench/run.py runs: the tiny steps are launch
    # bound, and OpenMP threads on a busy host make them crawl
    import torch
    torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
