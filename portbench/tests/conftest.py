"""The harness's own tests. `card`-marked tests need an NVIDIA card and skip without one
(decided inside the test, by the `card` fixture); the rest run on the CPU at tiny sizes.

    python -m pytest portbench/tests -q            # on the CPU
    python -m pytest portbench/tests -q -m card    # on a machine with an NVIDIA card
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false here")
    return torch.device("cuda")
