"""Percentiles and the request-level arithmetic of the end-to-end metrics
(frozen with the benchmark: later changes to the program cannot move the
yardstick).

Every time is in seconds from the window's start.  A request is *due* at
its arrival time; the open loop submits it then, whatever the system is
doing, so its latency counts from when it was due.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence


def percentile(xs: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default method)."""
    if not xs:
        raise ValueError("percentile of no values")
    s = sorted(xs)
    pos = (len(s) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def tail_mean(xs: Sequence[float], share: float) -> float:
    """The mean of the largest ``share`` of ``xs`` (at least one value):
    the expected value of the slowest tail, which averages some values
    where a percentile reads one."""
    s = sorted(xs, reverse=True)
    k = max(1, math.ceil(share * len(s)))
    return sum(s[:k]) / k


@dataclass
class Stamps:
    """What the benchmark saw of one request: when it was due, and the
    host time at which each of its tokens reached the host inside the
    window (each step ends in the program's read of the sampled tokens,
    so a clock read after the step is synchronous)."""
    due: float
    token_at: List[float] = field(default_factory=list)
    finished_at: Optional[float] = None


def ttft_s(reqs: Sequence[Stamps], seconds: float) -> List[float]:
    """Time to first token of every request due inside the window, from
    when it was due; one still waiting at the close counts the time it has
    waited so far."""
    out = []
    for r in reqs:
        if r.due >= seconds:
            continue
        first = r.token_at[0] if r.token_at else seconds
        out.append(first - r.due)
    return out


def tpot_s(reqs: Sequence[Stamps]) -> List[float]:
    """Time per output token after the first, of every request with two or
    more tokens inside the window: (its last token in the window - its
    first) / (tokens - 1)."""
    return [(r.token_at[-1] - r.token_at[0]) / (len(r.token_at) - 1)
            for r in reqs if len(r.token_at) >= 2]


def tpot_mean_s(reqs: Sequence[Stamps]) -> Optional[float]:
    """Mean time per output token after the first, over every such token
    in the window: the sum over requests of (last token - first) over the
    sum of (tokens - 1); a stall between two steps counts once for every
    request it held."""
    spans = [(r.token_at[-1] - r.token_at[0], len(r.token_at) - 1)
             for r in reqs if len(r.token_at) >= 2]
    n = sum(k for _, k in spans)
    return sum(t for t, _ in spans) / n if n else None


def tokens_in_window(reqs: Sequence[Stamps]) -> int:
    return sum(len(r.token_at) for r in reqs)
