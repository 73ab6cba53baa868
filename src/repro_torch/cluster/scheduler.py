"""Pluggable fleet scheduling: dispatch policies, placement, and clocks.

PipeBoost's premise (§2.1) is that many serverless tasks share one base
model and differ only by adapter — so *which server gets a request during
a burst* matters as much as how fast servers cold-start (HydraServe's
SLO-aware placement, λScale's scaling-state-aware request scheduling).
This module extracts the routing decision the ``ClusterRouter`` used to
hard-code into three separable pieces:

* ``DispatchPolicy`` — picks (request, server) pairs off the router queue.
  - ``LeastLoaded``     the pre-refactor behaviour, extracted verbatim:
                        fewest pending requests wins, ties by server id.
  - ``SloAware``        TTFT-deadline priority: earliest-deadline request
                        first, routed to the server minimizing *predicted*
                        first-token time (cold-start progress via the
                        engine's rounds-to-ready, epoch-switch drain
                        stalls via the batcher's resident-adapter set,
                        in-flight decode load via remaining tokens).
  - ``AdapterAffine``   prefers servers whose batcher already has the
                        request's adapter resident (no epoch-switch
                        stall), falling back to SLO-aware scoring.

* ``PlacementPolicy`` — decides what a *spawned* server preloads.  The
  model pool is decided by which pool's autoscaler fired (see
  ``cluster/fleet.py``); placement narrows the adapter set so a scale-up
  in a 100-adapter pool doesn't merge-load all 100.
  - ``PreloadAll``            every adapter the pool knows (default —
                              the pre-refactor behaviour).
  - ``HotAdapterPlacement``   the k most-recently-requested adapters.

* ``Clock`` — ``LogicalClock`` (discrete ticks, deterministic CI) vs
  ``WallClock`` (``time.monotonic``, real slices).  The router/autoscaler
  take ``now`` from the injected clock and never branch on its type: the
  same scheduler code runs simulation and real time.  ``sleep_until``
  lets the discrete-event replay loop jump a quiescent gap: logical
  clocks teleport, wall clocks actually sleep instead of hot-polling.

Dispatch is *batched*: ``select_many`` dispatches every placeable queued
request in one pass (one queue sort, one scoring sweep with virtual
load accounting), which is what lets a full-day trace replay run one
dispatch round per event instead of one O(Q log Q) ``select`` per
request.  ``select`` remains as a single-pick compatibility shim.

Pure host-side policy — no JAX.  Scoring peeks only at cheap scheduling
surfaces (queue depths, remaining-token counts, adapter residency,
load-plan progress), never at device state.

See ``docs/ARCHITECTURE.md`` § "Cluster: scheduling policies" for how
these pieces slot into the event engine.

The port's own copy of ``repro/cluster/scheduler.py``
(plain Python and numpy: the port imports nothing of the JAX package).
"""
from __future__ import annotations

import math
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import (Any, Dict, Optional, Protocol, Sequence, Tuple,
                    runtime_checkable)


# ---------------------------------------------------------------------------
# Clocks
# ---------------------------------------------------------------------------

@runtime_checkable
class Clock(Protocol):
    """Router time source.  ``now`` is seconds since the run started;
    ``advance`` is called once per router tick with the tick's nominal
    duration; ``sleep_until`` is how the discrete-event replay loop
    crosses a quiescent gap in one hop (see ``ClusterRouter.run``)."""

    def now(self) -> float:
        """Current time in seconds since the run started."""
        ...

    def advance(self, dt: float) -> None:
        """Account one router tick of nominal duration ``dt``."""
        ...

    def sleep_until(self, t: float) -> None:
        """Block (wall) or teleport (logical) until time ``t``."""
        ...


@dataclass
class LogicalClock:
    """Discrete-event time: one ``advance(tick_s)`` per router tick.
    Deterministic — the CI/simulation clock."""
    t: float = 0.0

    def now(self) -> float:
        """Current logical time (sum of advances and jumps)."""
        return self.t

    def advance(self, dt: float) -> None:
        """Step logical time forward by one tick of ``dt`` seconds."""
        self.t += dt

    def sleep_until(self, t: float) -> None:
        """Event-engine jump: teleport to ``t`` (never backwards)."""
        self.t = max(self.t, t)


class WallClock:
    """Real time off ``time.monotonic`` (zeroed at construction).

    ``advance`` is a no-op: wall time flows on its own while the tick does
    real work.  ``sleep_until`` really sleeps — under the event engine a
    quiescent fleet blocks until its next scheduled transition instead of
    hot-polling the tick loop.  Injecting this instead of ``LogicalClock``
    is the ONLY change needed to run the same router/autoscaler/policies
    on a real slice — no code forks anywhere downstream.
    """

    def __init__(self) -> None:
        self._t0 = time.monotonic()

    def now(self) -> float:
        """Seconds of real time since this clock was constructed."""
        return time.monotonic() - self._t0

    def advance(self, dt: float) -> None:
        """No-op: real time advances itself while the tick does work."""
        return None

    def sleep_until(self, t: float) -> None:
        """Really sleep until ``t`` (no-op if ``t`` already passed)."""
        dt = t - self.now()
        if dt > 0:
            time.sleep(dt)


# ---------------------------------------------------------------------------
# Dispatch policies
# ---------------------------------------------------------------------------
# ``servers`` are ClusterServer-likes exposing the scheduling surface:
# .sid .state .admitting .load .can_serve(req) .predicted_ready_s(now)
# .srv (ServingEngine: .resident_adapters() .predicted_step_cost_s()
#       .batcher.active / .batcher.free / .queued_requests())

def _capacity(server, n_slots: int) -> bool:
    return server.load < n_slots


class DispatchPolicy(Protocol):
    """One dispatch round: which queued requests go to which servers.

    ``select_many`` returns ``[(queue_index, server), ...]`` — every
    request placeable this round, indices into the *unmutated* queue, in
    dispatch order.  It must be equivalent to calling ``select``
    repeatedly with the router popping and submitting between calls;
    policies achieve that in one pass with *virtual load accounting*
    (each pick counts against its server's capacity and queue-wait score
    for subsequent picks).  An empty list means nothing can be dispatched
    (the backlog keeps feeding the autoscaler's SLO signal).

    ``select`` is the single-pick compatibility shim: first element of
    ``select_many`` or ``None``.  Neither may mutate the queue.
    """

    name: str

    def select(self, queue: Sequence, servers: Sequence, now: float,
               ccfg) -> Optional[Tuple[int, Any]]:
        """Pick ONE ``(queue_index, server)`` pair, or None."""
        ...

    def select_many(self, queue: Sequence, servers: Sequence, now: float,
                    ccfg) -> list:
        """Pick every placeable ``(queue_index, server)`` this round."""
        ...


@dataclass
class LeastLoaded:
    """Pre-refactor routing, extracted: FIFO queue order, dispatch to the
    admitting server with the fewest pending requests (ties by sid),
    capacity-bounded at ``n_slots`` outstanding per server.

    A request no current server can serve (placement preloaded a subset
    of adapters) is skipped, not allowed to block the head of the queue —
    with full preloads (the pre-refactor world) skipping never triggers
    and the decisions are identical to the old inline loop.
    """
    name: str = "least_loaded"

    def select_many(self, queue, servers, now, ccfg):
        """Batched FIFO dispatch: every placeable request in one pass."""
        # one FIFO pass; `extra` counts this round's virtual assignments so
        # each pick sees the load the repeated-select loop would have seen
        extra = {s.sid: 0 for s in servers}
        out = []
        for idx, req in enumerate(queue):
            cands = [s for s in servers
                     if s.admitting and s.load + extra[s.sid] < ccfg.n_slots
                     and s.can_serve(req)]
            if cands:
                best = min(cands,
                           key=lambda s: (s.load + extra[s.sid], s.sid))
                extra[best.sid] += 1
                out.append((idx, best))
                continue
            if any(s.admitting and s.load + extra[s.sid] < ccfg.n_slots
                   for s in servers):
                continue          # only THIS request is unservable: skip it
            break                 # fleet out of capacity: stop dispatching
        return out

    def select(self, queue, servers, now, ccfg):
        """Single-pick shim: first ``select_many`` pick or None."""
        picks = self.select_many(queue, servers, now, ccfg)
        return picks[0] if picks else None


@dataclass
class SloAware:
    """TTFT-deadline-priority dispatch to the predicted-fastest server.

    Request choice: the queued request with the earliest absolute TTFT
    deadline (``ServeRequest.deadline``; no deadline = +inf) — FIFO among
    equals.  Server choice: minimize predicted first-token time::

        t̂ = predicted_ready            (cold start / recovery remaining)
          + epoch_drain_stall          (batch busy on a DIFFERENT adapter:
                                        merged-LoRA must drain first —
                                        max remaining tokens in the batch)
          + slot_wait                  (no free slot: min remaining tokens
                                        until one opens)
          + queue_depth * step_cost    (admissions queued ahead)

    all in seconds of the injected clock.  ``step_cost_s`` pins the
    per-decode-step cost for deterministic scoring (benchmarks/tests);
    None consults the server's measured hook
    (``ServingEngine.predicted_step_cost_s``) with ``tick_s`` fallback.
    Warming servers are candidates (``consider_warming``): mid-burst it
    is often faster to queue on a server whose chain is one load-round
    from viable than behind a deep epoch on a serving one.

    Repartitioned servers (elastic recovery after a partial crash) stay
    in the candidate pool: their short ``repartition_ticks`` recovery
    window is already priced through ``predicted_ready_s``.  The lasting
    cost — fewer devices carrying the same pipeline — is priced per
    missing device via ``degraded_penalty_s_per_device`` (default 0 =
    capacity loss is free, matching pre-repartition behavior).
    """
    name: str = "slo_aware"
    step_cost_s: Optional[float] = None
    consider_warming: bool = True
    degraded_penalty_s_per_device: float = 0.0
    # multicast scale-out: a warm server sourcing peer transfers spends
    # link/host attention on them — flat penalty per active outbound send
    # (servers without the multicast surface read as 0 sends; default 0 =
    # sourcing is free, matching host-only behavior)
    source_penalty_s: float = 0.0
    # prefix-cache affinity: credit per prompt token a server's prefix
    # cache would reuse for this request (skipped prefill work).  Servers
    # without the surface read as 0 reusable tokens; default 0 = cache
    # state doesn't steer dispatch, matching pre-state-tier behavior
    prefix_bonus_s_per_token: float = 0.0

    def _step_cost(self, server, ccfg) -> float:
        if self.step_cost_s is not None:
            return self.step_cost_s
        return server.srv.predicted_step_cost_s(default=ccfg.tick_s)

    def predicted_first_token_s(self, server, req, now, ccfg) -> float:
        """Predicted seconds until ``server`` emits ``req``'s first
        token: readiness + epoch-drain stall + slot wait + queued-ahead
        work (the scoring model in the class docstring)."""
        cost = self._step_cost(server, ccfg)
        # predicted_ready_s counts ticks at nominal tick_s; convert to the
        # same per-tick cost unit as the drain/queue terms (under a wall
        # clock a tick really costs ~one measured decode step, not tick_s)
        t = server.predicted_ready_s(now) / ccfg.tick_s * cost
        b = server.srv.batcher
        rem = [max(0, r.max_new_tokens - len(r.generated))
               for r in b.active.values()]
        resident = server.srv.resident_adapters()
        if rem and req.adapter not in resident:
            t += max(rem) * cost                  # epoch barrier: full drain
        elif rem and not b.free:
            t += min(rem) * cost                  # wait for one slot
        # queued-ahead work: same-adapter requests ride the same admission
        # batch (≈ one step each); OTHER-adapter requests run whole epochs
        # before this adapter's turn — price their full remaining tokens,
        # or a dispatch can look fast on a server whose queue guarantees a
        # cross-epoch wait
        for q in server.srv.queued_requests():
            if q.adapter == req.adapter:
                t += cost
            else:
                t += max(1, q.max_new_tokens - len(q.generated)) * cost
        # degraded capacity: a repartitioned server runs the same pipeline
        # on fewer devices — flat penalty per dead device (sims without a
        # device list read as 0)
        t += self.degraded_penalty_s_per_device * \
            getattr(server, "degraded_devices", 0)
        # multicast sourcing load: outbound peer transfers this server is
        # feeding right now (0 when multicast is off or unsupported)
        t += self.source_penalty_s * getattr(server, "mc_active_sends", 0)
        # prefix-cache affinity: reusable cached-prefix tokens shave
        # prefill work — a credit, not a cost (0 when the cache is off or
        # the server lacks the surface)
        if self.prefix_bonus_s_per_token:
            fn = getattr(server, "predicted_prefix_tokens", None)
            if fn is not None:
                t -= self.prefix_bonus_s_per_token * fn(req)
        return t

    def _virtual_wait_s(self, server, assigned, req, ccfg) -> float:
        """Queue-wait contribution of this round's earlier virtual
        assignments to ``server`` — priced exactly like the real queued
        requests in ``predicted_first_token_s`` so one batched pass scores
        what a repeated single-select loop would have seen."""
        if not assigned:
            return 0.0
        cost = self._step_cost(server, ccfg)
        t = 0.0
        for q in assigned:
            if q.adapter == req.adapter:
                t += cost
            else:
                t += max(1, q.max_new_tokens - len(q.generated)) * cost
        return t

    def _candidates(self, req, servers, ccfg, extra=None):
        states = ("serving", "loading", "recovering") if self.consider_warming \
            else ("serving",)
        vload = (lambda s: len(extra[s.sid])) if extra is not None \
            else (lambda s: 0)
        return [s for s in servers
                if s.state in states and s.load + vload(s) < ccfg.n_slots
                and s.can_serve(req)]

    def _edf_order(self, reqs):
        # earliest-deadline-first; FIFO among equals (stable index tiebreak)
        return sorted(range(len(reqs)),
                      key=lambda i: (getattr(reqs[i], "deadline", None)
                                     if getattr(reqs[i], "deadline", None)
                                     is not None else math.inf, i))

    def select_many(self, queue, servers, now, ccfg):
        """Batched EDF dispatch: deadline-ordered sweep with virtual
        load/wait accounting per server."""
        # one EDF sort + one scoring sweep; a request no current server
        # can serve is skipped, never left blocking the rest.
        # (materialize once: the router hands us a deque, and O(n)
        # deque indexing inside the sort would make burst dispatch cubic)
        reqs = list(queue)
        extra = {s.sid: [] for s in servers}
        out = []
        for idx in self._edf_order(reqs):
            req = reqs[idx]
            cands = self._candidates(req, servers, ccfg, extra)
            if cands:
                best = min(cands, key=lambda s: (
                    self.predicted_first_token_s(s, req, now, ccfg)
                    + self._virtual_wait_s(s, extra[s.sid], req, ccfg),
                    s.sid))
                extra[best.sid].append(req)
                out.append((idx, best))
                continue
            if not any(s.state in ("serving", "loading", "recovering")
                       and s.load + len(extra[s.sid]) < ccfg.n_slots
                       for s in servers):
                break             # fleet out of capacity: stop dispatching
        return out

    def select(self, queue, servers, now, ccfg):
        """Single-pick shim: first ``select_many`` pick or None."""
        picks = self.select_many(queue, servers, now, ccfg)
        return picks[0] if picks else None


@dataclass
class AdapterAffine:
    """Adapter-affinity first, SLO-aware otherwise.

    Among capacity-holding serving servers, prefer those whose batcher
    already has the request's adapter resident (admission needs no
    epoch-switch drain); break ties by the SLO-aware predicted
    first-token time.  When no affine server exists, fall back to the
    full SLO-aware scoring (which prices the epoch stall instead of
    forbidding it).
    """
    name: str = "adapter_affine"
    slo: SloAware = field(default_factory=SloAware)

    def select_many(self, queue, servers, now, ccfg):
        """Batched dispatch: the SLO-aware sweep with a per-pick
        affinity override toward adapter-resident servers."""
        # the SLO-aware sweep, with an affinity override per pick: among
        # admitting servers holding the request's adapter resident, take
        # the best-scored one; virtual load lands on the FINAL choice
        slo = self.slo
        reqs = list(queue)
        extra = {s.sid: [] for s in servers}
        out = []
        for idx in slo._edf_order(reqs):
            req = reqs[idx]
            cands = slo._candidates(req, servers, ccfg, extra)
            if cands:
                score = lambda s: (
                    slo.predicted_first_token_s(s, req, now, ccfg)
                    + slo._virtual_wait_s(s, extra[s.sid], req, ccfg), s.sid)
                best = min(cands, key=score)
                affine = [s for s in servers
                          if s.admitting
                          and s.load + len(extra[s.sid]) < ccfg.n_slots
                          and s.can_serve(req)
                          and req.adapter in s.srv.resident_adapters()]
                if affine:
                    best = min(affine, key=score)
                extra[best.sid].append(req)
                out.append((idx, best))
                continue
            if not any(s.state in ("serving", "loading", "recovering")
                       and s.load + len(extra[s.sid]) < ccfg.n_slots
                       for s in servers):
                break             # fleet out of capacity: stop dispatching
        return out

    def select(self, queue, servers, now, ccfg):
        """Single-pick shim: first ``select_many`` pick or None."""
        picks = self.select_many(queue, servers, now, ccfg)
        return picks[0] if picks else None


DISPATCH_POLICIES = {
    "least_loaded": LeastLoaded,
    "slo_aware": SloAware,
    "adapter_affine": AdapterAffine,
}


def make_dispatch(name: str) -> DispatchPolicy:
    """CLI/bench helper: dispatch policy by registry name."""
    try:
        return DISPATCH_POLICIES[name]()
    except KeyError:
        raise ValueError(f"unknown dispatch policy {name!r}; "
                         f"available: {sorted(DISPATCH_POLICIES)}") from None


# ---------------------------------------------------------------------------
# Placement policies
# ---------------------------------------------------------------------------

class PlacementPolicy(Protocol):
    """What a freshly spawned server preloads.

    The *pool* (base model) is already decided — each pool's autoscaler
    spawns into its own pool (``cluster/fleet.py``); placement narrows
    the pool's adapter set to what the new server merge-loads.  ``recent``
    is the router's recently-requested adapter names, most recent last.
    """

    name: str

    def adapters_for(self, all_adapters: Dict[str, Any],
                     recent: Sequence[str]) -> Dict[str, Any]:
        """The adapter subset the new server should merge-load."""
        ...


@dataclass
class PreloadAll:
    """Every adapter the pool knows — the pre-refactor behaviour, and the
    right call while adapter sets are small."""
    name: str = "preload_all"

    def adapters_for(self, all_adapters, recent):
        """Everything the pool knows, history ignored."""
        return dict(all_adapters)


@dataclass
class HotAdapterPlacement:
    """Preload the ``k`` hottest adapters by recent request count (ties
    by recency), so a mid-burst scale-up pays k merge passes, not one per
    adapter the pool has ever seen.  Requests for non-resident adapters
    simply never dispatch to this server (``can_serve``) — they ride
    servers that do hold them."""
    k: int = 4
    name: str = "hot_adapters"

    def adapters_for(self, all_adapters, recent):
        """Top-``k`` adapters by recent request count (ties by recency);
        no history yet behaves like ``PreloadAll``."""
        seen = [a for a in recent if a in all_adapters]
        counts = Counter(seen)
        last_pos = {a: i for i, a in enumerate(seen)}
        hot = sorted(counts, key=lambda a: (-counts[a], -last_pos[a]))[:self.k]
        if not hot:                   # no history yet: behave like PreloadAll
            return dict(all_adapters)
        return {a: all_adapters[a] for a in hot}
