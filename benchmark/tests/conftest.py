"""The benchmark's own tests: on the CPU, at small sizes, with torch on
few threads. Run from the root of the checkout:

    python -m pytest benchmark/tests -q

Tests marked ``cuda`` run a cell on the card and skip elsewhere."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True, scope="session")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
