"""Multi-model fleet: named per-model server pools on one shared clock.

PipeBoost's serverless scenario (§2.1) is many functions sharing a few
base models and differing by adapter.  A ``Fleet`` maps that onto named
``ModelPool``s — each pool is a full ``ClusterRouter`` (queue, lifecycle,
crash re-route, its own autoscaler and dispatch/placement policies) over
its base model's params — while the fleet owns what must be shared:

* one injected ``Clock`` (logical or wall — same code either way),
* one ``ClusterMetrics`` store (cross-pool percentiles + per-model
  breakdown via ``summary_by_model``; request ids are fleet-global),
* trace demux: ``Arrival.model`` routes each request to its pool.

Pools over the *same* base model can share one params pytree (pass the
same object to several specs) — the functional analogue of N pools of
servers loading segments of one checkpoint, which is exactly the
many-adapters-one-base fleet the paper's premise implies.

``Fleet.run`` is discrete-event by default, like the router's: while any
pool has work it ticks every pool densely against the shared clock; when
EVERY pool is quiescent it jumps straight to the earliest next event
across the fleet.  See ``docs/ARCHITECTURE.md`` § "Cluster: multi-model
fleets".

The port's own copy of ``repro/cluster/fleet.py``
(plain Python and numpy: the port imports nothing of the JAX package).
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.cluster.autoscaler import Autoscaler
from repro_torch.cluster.metrics import ClusterMetrics
from repro_torch.cluster.router import ClusterConfig, ClusterRouter
from repro_torch.cluster.scheduler import (Clock, DispatchPolicy, LogicalClock,
                                           PlacementPolicy)
from repro_torch.cluster.state_tier import StateTier
from repro_torch.cluster.traces import Arrival, arrival_stream


@dataclass
class PoolSpec:
    """One model pool's recipe: base model + sizing + policies.  Fields
    left None fall back to the ``ClusterRouter`` defaults."""
    cfg: Any                                  # ArchConfig of the base model
    params: Any                               # base params (shareable)
    n_servers: int = 1
    ccfg: Optional[ClusterConfig] = None
    autoscaler: Optional[Autoscaler] = None
    adapter_params: Optional[Dict[str, Any]] = None
    dispatch: Optional[DispatchPolicy] = None
    placement: Optional[PlacementPolicy] = None
    server_factory: Any = None      # ClusterServer-like ctor (sim backends)
    materialize_prompts: bool = True
    # warm-state spill/resurrect across scale-down/up (one StateTier can
    # be shared fleet-wide: bundles are keyed by pool name); None = off
    state_tier: Optional[StateTier] = None


class Fleet:
    """Named per-model pools sharing a clock, metrics, and rid space."""

    def __init__(self, pools: Dict[str, PoolSpec], *,
                 clock: Optional[Clock] = None,
                 metrics: Optional[ClusterMetrics] = None,
                 default_model: Optional[str] = None):
        if not pools:
            raise ValueError("a fleet needs at least one pool")
        self._clock: Clock = clock or LogicalClock()
        self.metrics = metrics or ClusterMetrics()
        self.metrics.clock = self._clock
        self.default_model = default_model or next(iter(pools))
        if self.default_model not in pools:
            raise ValueError(f"default_model {self.default_model!r} is not "
                             f"a pool: {sorted(pools)}")
        rid = itertools.count()
        self.pools: Dict[str, ClusterRouter] = {}
        for name, spec in pools.items():
            self.pools[name] = ClusterRouter(
                spec.cfg, spec.params, n_servers=spec.n_servers,
                ccfg=spec.ccfg, autoscaler=spec.autoscaler,
                adapter_params=spec.adapter_params, metrics=self.metrics,
                dispatch=spec.dispatch, placement=spec.placement,
                clock=self._clock, model=name, rid_counter=rid,
                server_factory=spec.server_factory,
                materialize_prompts=spec.materialize_prompts,
                state_tier=spec.state_tier)

    @property
    def clock(self) -> float:
        return self._clock.now()

    def pool_for(self, arrival: Arrival) -> ClusterRouter:
        """The pool an arrival routes to (``Arrival.model``, or the
        fleet's default pool when the trace leaves it unset)."""
        name = arrival.model or self.default_model
        if name not in self.pools:
            raise ValueError(f"trace names model {name!r} but the fleet "
                             f"has pools for {sorted(self.pools)}")
        return self.pools[name]

    def submit(self, arrival: Arrival) -> int:
        """Demux one arrival to its pool; returns the fleet-global rid."""
        return self.pool_for(arrival).submit(arrival)

    def crash_server(self, model: str, sid: int,
                     device_ids: Optional[Sequence[int]] = None) -> None:
        """Crash server ``sid`` of pool ``model`` (all devices, or the
        ``device_ids`` subset for a partial crash)."""
        self.pools[model].crash_server(sid, device_ids)

    @property
    def pending(self) -> int:
        return sum(p.pending for p in self.pools.values())

    def tick(self) -> List:
        """One fleet tick: every pool ticks against the shared clock, then
        the clock advances ONCE (pools must agree on tick_s — asserted at
        run time, not assumed).  ``now`` is frozen across the pools so
        their gauges/events share one timestamp under wall clocks too."""
        now = self._clock.now()
        finished: List = []
        for pool in self.pools.values():
            finished.extend(pool.tick(advance=False, now=now))
        self._clock.advance(self._tick_s())
        return finished

    def _tick_s(self) -> float:
        ticks = {p.ccfg.tick_s for p in self.pools.values()}
        if len(ticks) != 1:
            raise ValueError(f"pools disagree on tick_s: {sorted(ticks)}")
        return next(iter(ticks))

    def run(self, trace, *, max_ticks: int = 200_000,
            engine: str = "event") -> List:
        """Replay a (multi-model) trace across the pools to completion.

        ``trace`` may be a sequence (sorted here) or a time-ordered
        iterator.  ``engine="event"`` (default) jumps the shared clock
        across fleet-wide quiescent gaps to the earliest next event of
        any pool; ``engine="tick"`` polls every tick (the equivalence
        oracle, identical token streams)."""
        if engine not in ("event", "tick"):
            raise ValueError(f"unknown engine {engine!r}; "
                             "expected 'event' or 'tick'")
        stream = arrival_stream(trace)
        nxt = next(stream, None)
        tick_s = self._tick_s()
        completed: List = []
        t = 0
        while t < max_ticks:
            while nxt is not None and nxt.time <= self.clock:
                self.submit(nxt)
                nxt = next(stream, None)
            if engine == "event" and all(p.quiescent
                                         for p in self.pools.values()):
                now = self.clock
                cands = [c for p in self.pools.values()
                         if (c := p.next_event_time()) is not None]
                if nxt is not None:
                    cands.append(nxt.time)
                if not cands:
                    break       # nothing can ever wake any pool again
                t_evt = min(cands)
                if t_evt - now > tick_s * 1e-6:
                    k = max(1, math.ceil((t_evt - now) / tick_s - 1e-9))
                    k = min(k, max_ticks - t)
                    t_wake = now + k * tick_s
                    for p in self.pools.values():
                        p._settle_gap(t_wake)
                    self._clock.sleep_until(t_wake)
                    t += k
                    continue
                # earliest event is due now: process it as a dense tick
            completed.extend(self.tick())
            t += 1
            if nxt is None and self.pending == 0:
                break
            # liveness: stop when EVERY pool is either done or provably
            # stuck (see ClusterRouter.stalled) — a pool still making
            # progress keeps the fleet ticking.  Evaluate every pool
            # (no short-circuit): stalled() advances per-pool counters.
            states = [(p, p.stalled(arrivals_left=nxt is not None))
                      for p in self.pools.values()]
            if self.pending and all(st or p.pending == 0
                                    for p, st in states):
                break
        for pool in self.pools.values():
            pool.finalize_metrics()
        return completed
