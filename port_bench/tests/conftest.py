"""The benchmark's own tests: the CPU ones run everywhere at sizes a CPU
holds; those marked ``card`` need an NVIDIA GPU and skip without one,
decided inside the ``card`` fixture, never at import."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the check runs at the cell's own "
                    "size on the card")
    return torch.device("cuda")


@pytest.fixture
def root() -> Path:
    return ROOT
