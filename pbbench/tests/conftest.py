"""The benchmark's own tests (``python -m pytest pbbench/tests``), run by
hand; the repository's test run collects ``tests/`` only.  Tests marked
``cuda`` run at a cell's own size and need the card: the ``card`` fixture
skips them without one, deciding when the test runs, never at import."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (BENCH, BENCH.parent / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
