"""Settings of the benchmark's own tests (`python -m pytest
benchmark/tests -q`). The tests marked `cuda` need an NVIDIA card and
skip elsewhere; on the card run them with `python -m pytest -q -m cuda
benchmark/tests`."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where none is visible")


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is visible (decided when the
    test runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device visible")
    return torch.device("cuda")
