#!/usr/bin/env python
"""``pbcheck`` launcher for the PyTorch port: the PipeBoost
static-analysis suite retargeted to torch and CUDA graphs.

Thin wrapper so the tool runs without exporting PYTHONPATH::

    python tools/pbcheck_torch.py src/repro_torch \
        --baseline tools/pbcheck_torch_baseline.json

Equivalent to ``PYTHONPATH=src python -m repro_torch.analysis ...``.  The
rule catalogue (R1-R6) is in ``src/repro_torch/analysis/__init__.py``;
the inline suppression syntax (``# pbcheck: disable=Rn (reason)``) and
the baseline workflow are the reference's.
"""
import os
import sys

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

from repro_torch.analysis.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
