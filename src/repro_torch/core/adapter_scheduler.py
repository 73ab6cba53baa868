"""Epoch-based LoRA adapter switching (paper §4.3.2, Fig. 5 / Fig. 14).

Requests are classified by adapter into per-adapter FIFO queues.  The
scheduler serves batches of the *active* adapter for an epoch, then rotates
to the next non-empty queue; merged-LoRA means a switch costs one merge pass
(unmerge old + merge new).  The eager baseline switches whenever the head of
the global FIFO differs from the active adapter — paying the merge cost per
flip, which is what Fig. 14 shows blowing up at high request rates.

Own copy of the policies of ``repro/core/adapter_scheduler.py``; the
policy object drives the serving engine (repro_torch/serving/engine.py)
through its ``next_batch`` interface.
"""
from __future__ import annotations

import math
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Deque, List, Optional, Tuple


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
