"""The device trace of a traced run's steady sub-window, reduced to what
the per-layer readers and the result's ``breakdown`` need.

``torch.profiler`` records the CPU and the card for a few seconds of the
window (``trace_seconds`` of the traffic mix), inside the benchmark's own
``pbb.window`` range.  The raw events are read once (no Chrome trace is
written, and no per-event Python objects are built beyond one pass): the
device's busy time is the union of its activities' intervals, as the
program's ``tools/decode_profile.py`` takes it; each kernel name's device
time is summed; each idle gap of the device is named by the innermost
host range that spans its middle (``pbb.idle``: the open loop waited for
an arrival; ``pbb.step``: the program's Python between launches;
``pbb.stamp``: the benchmark's own bookkeeping; an ``aten::`` op or a
CUDA call: that op's host work).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

WINDOW = "pbb.window"
LABELED_GAPS = 400          # the longest gaps that get a host label


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float] = field(default_factory=dict)
    idle_by_host: Dict[str, float] = field(default_factory=dict)

    def time_of(self, *patterns: str) -> float:
        """Device seconds of the kernels whose names hold any pattern."""
        return sum(t for k, t in self.kernel_s.items()
                   if any(p in k for p in patterns))

    def breakdown(self) -> Dict[str, List[Tuple[str, float]]]:
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:160], v] for k, v in top],
                "idle_gaps": [[k[:160], v] for k, v in gaps]}


def _ns(e, attr: str) -> int:
    fn = getattr(e, f"{attr}_ns", None)
    return int(fn()) if fn is not None else int(getattr(e, f"{attr}_us")()
                                                * 1000)


def reduce(prof) -> TraceSummary:
    """The summary of a stopped ``torch.profiler.profile``."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev: List[Tuple[int, int, str]] = []
    host: List[Tuple[int, int, str]] = []
    w0 = w1 = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = _ns(e, "start")
        t = s + int(e.duration_ns())
        if e.device_type() == cuda:
            if not name.startswith("pbb."):      # annotations' own ranges
                dev.append((s, t, name))
        elif name == WINDOW:
            w0, w1 = s, t
        else:
            host.append((s, t, name))
    if w0 is None:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    kernel_s: Dict[str, float] = {}
    spans = []
    for s, t, name in dev:
        s, t = max(s, w0), min(t, w1)
        if t > s:
            kernel_s[name] = kernel_s.get(name, 0.0) + (t - s) * 1e-9
            spans.append((s, t))
    spans.sort()
    merged: List[List[int]] = []
    for s, t in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged)
    edges = [w0] + [x for st in merged for x in st] + [w1]
    gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
            for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)
    hs = np.array([h[0] for h in host], dtype=np.int64)
    he = np.array([h[1] for h in host], dtype=np.int64)
    idle: Dict[str, float] = {}
    for length, s, t in gaps[:LABELED_GAPS]:
        mid = (s + t) // 2
        inside = np.nonzero((hs <= mid) & (he >= mid))[0]
        label = (host[inside[np.argmin(he[inside] - hs[inside])]][2]
                 if inside.size else "no host range")
        idle[label] = idle.get(label, 0.0) + length * 1e-9
    rest = sum(g[0] for g in gaps[LABELED_GAPS:]) * 1e-9
    if rest:
        idle["shorter gaps"] = rest
    return TraceSummary((w1 - w0) * 1e-9, busy * 1e-9, kernel_s, idle)
