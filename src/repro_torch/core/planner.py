"""Pipeline-parallel model-loading planner (paper §4.2, §4.4.1).

The planner is pure algorithm — no JAX — and is the heart of PipeBoost:

* ``make_segments``       — partition L layers into N contiguous segments with
                            balanced byte sizes (homogeneous devices).
* ``rotated_load_order``  — device *i* loads segments ``i, i+1, …, i-1`` so
                            the union of first-loads covers the model after
                            each device transfers only 1/N of the bytes
                            (paper Fig. 2c).
* ``reassign``            — failure recovery: re-partition the segment ring
                            over survivors obeying the paper's two principles
                            (Load Balance, Layer Contiguity), reusing what is
                            already on each device (paper §4.4.2, Fig. 7a).
* ``viable_chain``        — find a pipeline chain over the currently loaded
                            segments (used to decide whether inference can
                            continue after a crash without re-loading).

Own copy of ``repro/core/planner.py`` for the port.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Segment:
    """A contiguous run of model layers (plus optional head/tail extras)."""
    idx: int
    layer_start: int
    layer_end: int           # exclusive
    bytes: int

    @property
    def n_layers(self) -> int:
        return self.layer_end - self.layer_start


@dataclass
class LoadPlan:
    """Per-device ordered segment loading schedule."""
    segments: List[Segment]
    order: Dict[int, List[int]]          # device -> segment idx order
    serve_assignment: Dict[int, List[int]]  # device -> segments it serves in
                                            # the initial pipeline chain

    @property
    def n_devices(self) -> int:
        return len(self.order)


def make_segments(layer_bytes: Sequence[int], n_segments: int) -> List[Segment]:
    """Balanced contiguous partition of layers into segments.

    Greedy sweep targeting equal cumulative bytes; always yields exactly
    ``n_segments`` non-empty segments (requires L >= n_segments).
    """
    L = len(layer_bytes)
    if L < n_segments:
        raise ValueError(f"{L} layers < {n_segments} segments")
    total = sum(layer_bytes)
    segments: List[Segment] = []
    start = 0
    acc = 0
    for s in range(n_segments):
        remaining_segs = n_segments - s
        remaining_layers = L - start
        target = (total - acc) / remaining_segs
        end = start
        seg_bytes = 0
        # must leave at least 1 layer per remaining segment
        max_end = L - (remaining_segs - 1)
        while end < max_end:
            nxt = seg_bytes + layer_bytes[end]
            # take the layer if we are under target or taking it is closer
            if seg_bytes > 0 and abs(nxt - target) > abs(seg_bytes - target):
                break
            seg_bytes = nxt
            end += 1
        if end == start:  # always take at least one layer
            seg_bytes = layer_bytes[start]
            end = start + 1
        segments.append(Segment(s, start, end, seg_bytes))
        acc += seg_bytes
        start = end
    assert start == L
    return segments


def rotated_load_order(n_devices: int, n_segments: Optional[int] = None
                       ) -> Dict[int, List[int]]:
    """Device i loads segments [i, i+1, ..., i-1] (mod N) — paper Fig. 2c."""
    n_segments = n_segments or n_devices
    assert n_segments % n_devices == 0, (n_segments, n_devices)
    per = n_segments // n_devices
    out = {}
    for d in range(n_devices):
        first = d * per
        out[d] = [(first + j) % n_segments for j in range(n_segments)]
    return out


def make_plan(layer_bytes: Sequence[int], n_devices: int,
              n_segments: Optional[int] = None) -> LoadPlan:
    n_segments = n_segments or n_devices
    segs = make_segments(layer_bytes, n_segments)
    order = rotated_load_order(n_devices, n_segments)
    per = n_segments // n_devices
    serve = {d: list(range(d * per, (d + 1) * per)) for d in range(n_devices)}
    return LoadPlan(segs, order, serve)


# ---------------------------------------------------------------------------
# Recovery (paper §4.4.2)
# ---------------------------------------------------------------------------

def _contiguous_spans(n_segments: int, n_parts: int) -> List[List[int]]:
    """Split segment ids 0..n-1 into n_parts contiguous spans, sizes
    differing by at most 1 (Load Balance + Layer Contiguity)."""
    base = n_segments // n_parts
    rem = n_segments % n_parts
    spans = []
    start = 0
    for p in range(n_parts):
        size = base + (1 if p < rem else 0)
        spans.append(list(range(start, start + size)))
        start += size
    return spans


def reassign(plan: LoadPlan, loaded: Dict[int, Sequence[int]],
             survivors: Sequence[int]) -> LoadPlan:
    """Re-plan after failures.

    ``loaded``: device -> segment ids already resident (survivors only are
    consulted).  Survivors (sorted by device id) receive contiguous spans of
    the segment ring; each survivor's new load order puts its still-missing
    span segments first (in pipeline order), then the remaining segments
    (background fill), preserving already-loaded work.

    Matches the paper's example: devices {0,1,2,3}, crash {1,2} during
    loading with loaded = {0:[0], 3:[3]} -> spans [0,1] / [2,3];
    device 0 keeps order [0,1,...], device 3 loads 2 next (already has 3).
    """
    surv = sorted(survivors)
    n_seg = len(plan.segments)
    spans = _contiguous_spans(n_seg, len(surv))
    # assign spans to survivors maximizing reuse of already-loaded segments:
    # survivors are in ring order, spans are in ring order — try all ring
    # rotations of the span assignment and keep the one with max overlap.
    best = None
    for rot in range(len(surv)):
        overlap = 0
        for j, d in enumerate(surv):
            span = spans[(j + rot) % len(surv)]
            overlap += len(set(span) & set(loaded.get(d, ())))
        if best is None or overlap > best[0]:
            best = (overlap, rot)
    rot = best[1]

    order: Dict[int, List[int]] = {}
    serve: Dict[int, List[int]] = {}
    for j, d in enumerate(surv):
        span = spans[(j + rot) % len(surv)]
        serve[d] = span
        have = set(loaded.get(d, ()))
        missing_span = [s for s in span if s not in have]
        rest = [s for s in range(n_seg)
                if s not in have and s not in missing_span]
        # background fill continues the ring from the end of the span
        tail = span[-1] if span else 0
        rest.sort(key=lambda s: (s - tail) % n_seg)
        order[d] = missing_span + rest
    return LoadPlan(plan.segments, order, serve)


def viable_chain(plan: LoadPlan, loaded: Dict[int, Sequence[int]],
                 survivors: Sequence[int]) -> Optional[List[Tuple[int, int]]]:
    """Find a pipeline chain [(device, segment), ...] covering segments
    0..n-1 in order using only loaded segments on survivors; prefers staying
    on the same device for consecutive segments (Layer Contiguity).
    Returns None if some segment is not loaded anywhere. (paper §4.4.2:
    'scans the GPUs to assess the distribution of loaded model layers and
    identifies a viable chain')."""
    surv = sorted(survivors)
    have: Dict[int, set] = {d: set(loaded.get(d, ())) for d in surv}
    chain: List[Tuple[int, int]] = []
    prev_d: Optional[int] = None
    for s in range(len(plan.segments)):
        owners = [d for d in surv if s in have[d]]
        if not owners:
            return None
        if prev_d in owners:
            d = prev_d  # stay: no inter-device hop
        else:
            # fewest future hops heuristic: owner that also has s+1
            nxt = [d for d in owners if s + 1 in have[d]]
            d = (nxt or owners)[0]
        chain.append((d, s))
        prev_d = d
    return chain

