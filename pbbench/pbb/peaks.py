"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity), frozen from the program's ``launch/rooflines.py``.

Every peak holds at the card's full 700 W power limit; the run prints the
card's ``power.limit`` beside every share of them.
"""
from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12          # bytes/s


def least_s(flops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    """The least time the card can take: the larger of the operations over
    the peak of ``dtype`` and the bytes over the HBM bandwidth."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BW)
