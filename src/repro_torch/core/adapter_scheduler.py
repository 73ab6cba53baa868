"""Epoch-based LoRA adapter switching (paper §4.3.2, Fig. 5 / Fig. 14).

Requests are classified by adapter into per-adapter FIFO queues.  The
scheduler serves batches of the *active* adapter for an epoch, then rotates
to the next non-empty queue; merged-LoRA means a switch costs one merge pass
(unmerge old + merge new).  The eager baseline switches whenever the head of
the global FIFO differs from the active adapter — paying the merge cost per
flip, which is what Fig. 14 shows blowing up at high request rates.

Own copy of the policies of ``repro/core/adapter_scheduler.py``; the
policy object drives the serving engine (repro_torch/serving/engine.py)
through its ``next_batch`` interface.  ``simulate_adapter_serving`` is the
reference's discrete-event model of one replica under either policy (the
paper's Fig. 14).
"""
from __future__ import annotations

import math
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple


@dataclass
class Request:
    rid: int
    adapter: str
    arrival: float
    service: float            # seconds of compute once scheduled
    start: float = -1.0
    finish: float = -1.0
    model: str = ""           # fleet pool the request targets (multi-model)
    deadline: float = math.inf  # absolute TTFT deadline (SLO-aware dispatch)

    @property
    def latency(self) -> float:
        return self.finish - self.arrival


@dataclass
class EpochSchedulerPolicy:
    """Groups per-adapter, serves the active adapter up to ``epoch_budget``
    requests (or until its queue drains), then rotates."""
    epoch_budget: int = 8
    max_batch: int = 8

    def make_state(self):
        return {"queues": OrderedDict(), "active": None, "served_in_epoch": 0}

    def enqueue(self, state, req: Request):
        state["queues"].setdefault(req.adapter, deque()).append(req)

    def peek_adapter(self, state) -> Optional[str]:
        """Adapter the next next_batch() would serve (no state change)."""
        queues = state["queues"]
        nonempty = [a for a, q in queues.items() if q]
        if not nonempty:
            return None
        active = state["active"]
        if (active in nonempty
                and state["served_in_epoch"] < self.epoch_budget):
            return active
        keys = list(queues.keys())
        if active in keys:
            i = keys.index(active)
            order = keys[i + 1:] + keys[:i + 1]
        else:
            order = keys
        return next(a for a in order if queues[a])

    def next_batch(self, state) -> Tuple[Optional[str], List[Request]]:
        queues: "OrderedDict[str, Deque[Request]]" = state["queues"]
        nonempty = [a for a, q in queues.items() if q]
        if not nonempty:
            return None, []
        active = state["active"]
        rotate = (active not in nonempty
                  or state["served_in_epoch"] >= self.epoch_budget)
        if rotate:
            # round-robin to the next non-empty adapter after `active`
            keys = list(queues.keys())
            if active in keys:
                i = keys.index(active)
                order = keys[i + 1:] + keys[:i + 1]
            else:
                order = keys
            active = next(a for a in order if queues[a])
            state["active"] = active
            state["served_in_epoch"] = 0
        q = queues[active]
        batch = [q.popleft() for _ in range(min(self.max_batch, len(q)))]
        state["served_in_epoch"] += len(batch)
        return active, batch

    def requeue_front(self, state, items):
        """Return unadmitted items to the head of their queues (the serving
        engine ran out of free slots mid-batch)."""
        for it in reversed(items):
            state["queues"].setdefault(it.adapter, deque()).appendleft(it)
        state["served_in_epoch"] = max(
            0, state["served_in_epoch"] - len(items))


@dataclass
class EagerPolicy:
    """Serve strictly in arrival order; switch adapters whenever the head
    request needs a different one (the paper's no-scheduling baseline)."""
    max_batch: int = 8

    def make_state(self):
        return {"fifo": deque(), "active": None}

    def enqueue(self, state, req: Request):
        state["fifo"].append(req)

    def peek_adapter(self, state) -> Optional[str]:
        fifo = state["fifo"]
        return fifo[0].adapter if fifo else None

    def next_batch(self, state) -> Tuple[Optional[str], List[Request]]:
        fifo: Deque[Request] = state["fifo"]
        if not fifo:
            return None, []
        adapter = fifo[0].adapter
        state["active"] = adapter
        batch = []
        while fifo and fifo[0].adapter == adapter and len(batch) < self.max_batch:
            batch.append(fifo.popleft())
        return adapter, batch

    def requeue_front(self, state, items):
        for it in reversed(items):
            state["fifo"].appendleft(it)


def simulate_adapter_serving(policy, *, rps: float, horizon: float,
                             n_adapters: int = 2, switch_prob: float = 0.2,
                             service_s: float = 0.05, merge_s: float = 0.15,
                             seed: int = 0) -> Dict[str, float]:
    """Deterministic DES of one serving replica under a request stream where
    consecutive requests switch adapters with ``switch_prob``.

    Returns mean/var/p99 completion latency and the number of merges.
    """
    rng_state = [seed * 2654435761 % 2**32 or 1]

    def rnd() -> float:
        rng_state[0] = (1103515245 * rng_state[0] + 12345) % 2**31
        return rng_state[0] / float(2**31)

    # arrival stream
    reqs: List[Request] = []
    t, adapter_i, rid = 0.0, 0, 0
    while True:
        t += -math.log(max(rnd(), 1e-12)) / max(rps, 1e-9)
        if t >= horizon:
            break
        if rnd() < switch_prob:
            adapter_i = (adapter_i + 1) % n_adapters
        reqs.append(Request(rid, f"lora{adapter_i}", t, service_s))
        rid += 1

    state = policy.make_state()
    clock = 0.0
    active: Optional[str] = None
    merges = 0
    done: List[Request] = []
    i = 0
    while i < len(reqs) or _pending(state):
        # admit everything that has arrived by `clock`
        while i < len(reqs) and reqs[i].arrival <= clock:
            policy.enqueue(state, reqs[i])
            i += 1
        adapter, batch = policy.next_batch(state)
        if adapter is None:
            if i < len(reqs):
                clock = max(clock, reqs[i].arrival)
                continue
            break
        if adapter != active:
            clock += merge_s          # unmerge + merge pass
            active = adapter
            merges += 1
        # continuous batching: batch completes together
        clock += batch[0].service
        for r in batch:
            r.start = clock - r.service
            r.finish = clock
            done.append(r)
    lats = [r.latency for r in done]
    if not lats:
        return {"mean": 0.0, "var": 0.0, "p99": 0.0, "merges": 0.0, "n": 0.0}
    mean = sum(lats) / len(lats)
    var = sum((x - mean) ** 2 for x in lats) / len(lats)
    p99 = sorted(lats)[min(len(lats) - 1, int(0.99 * len(lats)))]
    return {"mean": mean, "var": var, "p99": p99,
            "merges": float(merges), "n": float(len(lats))}


def _pending(state) -> bool:
    if "fifo" in state:
        return bool(state["fifo"])
    return any(q for q in state.get("queues", {}).values())
