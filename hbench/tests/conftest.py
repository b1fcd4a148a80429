"""Set-up of the benchmark's tests: the benchmark's folder and the
program's sources on the path, and the fixture of the tests that need a card."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

HBENCH = Path(__file__).resolve().parents[1]
for p in (str(HBENCH.parent / "src"), str(HBENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """Skips the test where no CUDA card is visible (decided here, at run time)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
