"""Fixtures of the benchmark's tests: tiny tables on the CPU."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SSB_TINY = {"sizes": {"customer": 600, "supplier": 40, "part": 1600,
                      "orders": 15000, "lineorder": 60000, "date": 2556}}
SEED = 2**31 + 12345    # past 32 signed bits, as a check's seeds may be


def tiny(config: dict) -> dict:
    """The configuration at a size the CPU runs in seconds."""
    return dict(config, **SSB_TINY)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
