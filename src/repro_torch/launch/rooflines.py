"""Roofline terms for one NVIDIA H100 (the port of
``repro/launch/rooflines.py``).

Terms, per device (the dry run counts the work of one device's shards):
    compute    = FLOPs / peak FLOP/s of their type   [s]
    memory     = bytes / HBM bandwidth                [s]
    collective = collective bytes / link bandwidth    [s]

Hardware constants: the published peaks of one H100 SXM (NVIDIA's data
sheet, dense rates without sparsity): 989 TFLOP/s in bf16 on the tensor
cores, 67 TFLOP/s in float32 outside them, 3.35 TB/s of HBM3.  The link
term uses NVLink 4: 18 links of 25 GB/s a direction, 450 GB/s a direction
a card (900 GB/s both ways, the data sheet's figure), the rate at which a
card's share of a ring collective leaves it.  Every peak holds at the
card's full 700 W power limit; a card set below it runs slower under load,
so a share of these peaks is stated with the card's power limit
(``nvidia-smi --query-gpu=name,power.limit``) beside it.

The reference's ``cost_analysis`` counts a ``lax.scan`` body once, so its
dry run lowers two depth-reduced unrolled variants (L1, L2) and
extrapolates linearly; the port's dry run traces the same two depths
(the eager layer loop has no scan, but a trace's time grows with depth)
and keeps ``extrapolate``:  m(L) = m(L1) + (m(L2) - m(L1)) / (L2 - L1) *
(L - L1).  Exact for uniform stacks.

The reference's ``collective_bytes(hlo_text)`` parses collectives out of
the compiled HLO.  There is no HLO here: the dry run counts the
collectives its trace issues (the ``c10d_functional`` ops that DTensor's
redistributions run), by kind, with all-reduce charged twice as the
reference charges it.

``bound`` is the least time one kernel call can take, as ``chip_smoke.py``
prints it beside each kernel's measured time, from the kernel module's
``cost()``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

PEAK_FLOPS: Dict[str, float] = {"bfloat16": 989e12, "float16": 989e12,
                                "float32": 67e12}   # per card
HBM_BW = 3.35e12         # bytes/s per card
LINK_BW = 450e9          # bytes/s per card and direction (NVLink 4)


@dataclass
class RooflineTerms:
    flops: float               # per device
    bytes_accessed: float      # per device (HBM proxy)
    coll_bytes: float          # per device
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def total_s(self) -> float:
        # optimistic perfectly-overlapped lower bound = max term
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> Dict:
        return {"flops": self.flops, "bytes": self.bytes_accessed,
                "coll_bytes": self.coll_bytes, "compute_s": self.compute_s,
                "memory_s": self.memory_s, "collective_s": self.collective_s,
                "dominant": self.dominant}


def make_terms(flops: float, bytes_accessed: float, coll_bytes: float, *,
               f32_flops: float = 0.0) -> RooflineTerms:
    """The three terms; ``f32_flops`` of the ``flops`` run at the float32
    peak, the rest at the bf16 peak."""
    return RooflineTerms(
        flops=flops, bytes_accessed=bytes_accessed, coll_bytes=coll_bytes,
        compute_s=((flops - f32_flops) / PEAK_FLOPS["bfloat16"]
                   + f32_flops / PEAK_FLOPS["float32"]),
        memory_s=bytes_accessed / HBM_BW,
        collective_s=coll_bytes / LINK_BW,
    )


def extrapolate(m1: float, m2: float, l1: int, l2: int, l_full: int) -> float:
    """Linear-in-depth extrapolation of a cost metric."""
    per_layer = (m2 - m1) / max(l2 - l1, 1)
    return max(0.0, m1 + per_layer * (l_full - l1))


def bound(nbytes: float, flops: float, dtype: str) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the bytes over the HBM
    bandwidth and the operations over the peak of ``dtype``."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
