"""The one traffic generator: every mix is a data file of parameters
(``workloads/<name>.json``) that this module reads.

Keys of a mix:

* ``arrivals``: ``{"kind": "gamma", "rate": r, "cv2": c}`` (an open loop:
  Gamma-renewal inter-arrival gaps of mean 1/r and squared coefficient of
  variation c, as the program's ``cluster/traces.py`` ``gamma_trace``
  draws them; c = 1 is Poisson, c > 1 bursty) or ``{"kind": "backlog",
  "requests": n}`` (an offline batch: n requests queued at the start, as
  many as there are slots admitted during set-up);
* ``prompt_len``, ``output_len``: ``{"dist": "lognormal", "median": m,
  "sigma": s, "min": a, "max": b}`` or ``{"dist": "uniform", "min": a,
  "max": b}``, in tokens;
* ``adapters``: the share of requests on each adapter name (``base`` is the
  base model).

The seed changes the order of the work, not the work: every seed gets the
same multiset of gaps, prompt lengths, output lengths and adapters, each
list in an order of its own drawn uniformly from the seed, and its own
prompt tokens.  Lengths are the distribution's quantiles at (i + 1/2) / n;
Gamma gaps are a sample from a fixed stream, scaled so that the n gaps
fill the window exactly (an open loop's n is rate x seconds).  A uniform
order keeps what a renewal process has: any run of short gaps (a burst)
and any run of one adapter's requests can fall anywhere in the window.
Without the fixed multiset the seed's draw, not the system, moved a tail
over some tens of requests by a third (PERF.md §6).
"""
from __future__ import annotations

import math
import statistics
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

GAMMA_STREAM = 0x9E3779B9     # the fixed stream of the Gamma gaps' values


@dataclass
class Request:
    rid: int
    due: float                # seconds from the window's start
    prompt: np.ndarray        # int64 token ids
    out_len: int              # tokens to generate (no EOS: all of them)
    adapter: Optional[str]    # None: the base model


def stream(seed: int, k: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [seed & 0xFFFFFFFFFFFFFFFF, k]))


def quantile_lengths(spec: Dict, n: int) -> np.ndarray:
    """``n`` lengths at the distribution's quantiles (i + 1/2) / n."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "uniform":
        x = lo + (hi - lo) * u
    elif spec["dist"] == "lognormal":
        z = np.array([statistics.NormalDist().inv_cdf(float(p)) for p in u])
        x = float(spec["median"]) * np.exp(float(spec["sigma"]) * z)
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def gamma_gaps(cv2: float, n: int, total: float) -> np.ndarray:
    """``n`` Gamma gaps of squared coefficient of variation ``cv2`` (shape
    1/cv2) from the fixed stream, scaled to sum to ``total``."""
    g = np.random.default_rng(GAMMA_STREAM).gamma(1.0 / cv2, 1.0, n)
    return g * total / g.sum()


def adapter_counts(shares: Dict[str, float], n: int) -> List[Optional[str]]:
    """``n`` adapter names in the given shares (largest remainders)."""
    names = list(shares)
    exact = [shares[a] * n / sum(shares.values()) for a in names]
    counts = [math.floor(x) for x in exact]
    order = sorted(range(len(names)), key=lambda i: counts[i] - exact[i])
    for i in order[:n - sum(counts)]:
        counts[i] += 1
    out: List[Optional[str]] = []
    for a, c in zip(names, counts):
        out += [None if a == "base" else a] * c
    return out


def n_requests(spec: Dict, seconds: float) -> int:
    arr = spec["arrivals"]
    if arr["kind"] == "backlog":
        return int(arr["requests"])
    return max(1, int(round(arr["rate"] * seconds)))


def make(spec: Dict, seed: int, seconds: float, vocab: int) -> List[Request]:
    """The requests of one run, in order of when they are due."""
    n = n_requests(spec, seconds)
    arr = spec["arrivals"]
    if arr["kind"] == "gamma":
        gaps = stream(seed, 1).permutation(
            gamma_gaps(float(arr["cv2"]), n, seconds))
        due = np.cumsum(gaps) - gaps         # the first is due at 0
    elif arr["kind"] == "backlog":
        due = np.zeros(n)
    else:
        raise ValueError(f"unknown arrivals {arr['kind']!r}")
    plen = stream(seed, 2).permutation(
        quantile_lengths(spec["prompt_len"], n))
    olen = stream(seed, 3).permutation(
        quantile_lengths(spec["output_len"], n))
    names = adapter_counts(spec.get("adapters", {"base": 1.0}), n)
    adapters = [names[i] for i in stream(seed, 4).permutation(n)]
    toks = stream(seed, 5).integers(0, vocab, size=int(plen.sum()))
    out, at = [], 0
    for i in range(n):
        out.append(Request(i, float(due[i]), toks[at:at + plen[i]],
                           int(olen[i]), adapters[i]))
        at += int(plen[i])
    return out
