"""Cluster router: bursty traffic over autoscaled PipeBoost servers.

Each ``ClusterServer`` composes the two single-server pieces the repo
already proves correct: a ``PipeBoostEngine`` (pipelined cold start, crash,
recovery, strategy switch — core/engine.py) gating a continuous-batched
``ServingEngine`` (serving/engine.py).  The ``ClusterRouter`` owns the
queue, the server lifecycle, and crash re-routing; the actual scheduling
decisions are delegated to pluggable pieces from ``cluster/scheduler.py``:

* a ``DispatchPolicy`` picks which queued request goes to which server
  (``LeastLoaded`` is the default and reproduces the pre-refactor
  routing; ``SloAware``/``AdapterAffine`` add deadline- and
  adapter-aware scheduling);
* a ``PlacementPolicy`` decides which adapters a spawned server preloads;
* a ``Clock`` (``LogicalClock`` ticks or ``WallClock`` off
  ``time.monotonic``) is injected through router, autoscaler, and
  metrics — simulation and real slices run the SAME code.

Crash re-routing is state-preserving: a crashed server's in-flight
requests carry their ``KVSnapshot`` to survivors, so greedy outputs are
EXACTLY the tokens of a crash-free run (the cluster-level analogue of the
engine's KV-reconstruction exactness).

Server lifecycle::

    spawn -> loading --ready--> serving --crash(partial)--> recovering
    serving --crash(total)--> down --rejoin--> loading
    serving --idle + autoscaler--> retired

Time: one router tick = ``tick_s`` clock seconds; per tick a loading
server advances ``load_rounds_per_tick`` rounds and a serving server runs
one continuous-batching decode step.

``run`` is a *discrete-event* loop (``engine="event"``, the default):
while any server has work (loading, recovering, decoding, background
fill) or the queue is non-empty, it processes every tick densely —
bit-identical to the legacy polling loop (``engine="tick"``, kept as the
equivalence oracle).  The moment the fleet goes quiescent it jumps the
clock straight to the next lifecycle event — next arrival, idle-retire
deadline, scheduled rejoin — aligned to the tick grid, so a full-day
trace with million-row gaps replays in seconds instead of polling every
server every ``tick_s``.  See ``docs/ARCHITECTURE.md`` § "Cluster: the
event engine".

The port of ``repro/cluster/router.py``: the router, its event engine and
its crash, chaos, migration and state-tier handling are the reference's
code; each ``ClusterServer`` runs the port's ``PipeBoostEngine`` and
``ServingEngine`` on the params' device (the card, or the CPU in the
tests).  The servers of one process share the base params and the merged
adapters; each server's batcher holds its own cache, its own copy of the
adapters' target leaves and its own captured decode step, all of which a
retired server frees.
"""
from __future__ import annotations

import itertools
import math
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.cluster.autoscaler import Autoscaler
from repro_torch.cluster.metrics import ClusterMetrics
from repro_torch.cluster.multicast import MulticastConfig, MulticastManager
from repro_torch.cluster.scheduler import (Clock, DispatchPolicy, LeastLoaded,
                                           LogicalClock, PlacementPolicy,
                                           PreloadAll)
from repro_torch.cluster.state_tier import StateTier
from repro_torch.cluster.traces import Arrival, arrival_stream, prompt_tokens
from repro_torch.configs.base import ArchConfig
from repro_torch.core.adapter_scheduler import EpochSchedulerPolicy
from repro_torch.core.engine import PipeBoostEngine
from repro_torch.core.simulator import GPU_PAPER, state_resurrect_time
from repro_torch.serving.engine import (ServeRequest, ServingEngine,
                                        quantized_greedy)
from repro_torch.serving.prefix_cache import PrefixCache


_PROMPT_STUBS: Dict[int, np.ndarray] = {}


def _prompt_stub(n: int) -> np.ndarray:
    """Shared zero prompt of length ``n`` for routers running with
    ``materialize_prompts=False`` (modeled backends never read the token
    values; ``len(req.tokens)`` stays truthful for accounting)."""
    arr = _PROMPT_STUBS.get(n)
    if arr is None:
        arr = _PROMPT_STUBS[n] = np.zeros(n, dtype=np.int32)
    return arr


@dataclass
class ClusterConfig:
    """Per-server shape + per-tick budgets shared by every server the
    router spawns (the field comments are the documentation)."""
    n_devices: int = 2             # logical devices per server
    n_slots: int = 4               # continuous-batching slots per server
    max_len: int = 96
    tick_s: float = 0.05           # logical seconds per router tick
    load_rounds_per_tick: int = 1  # cold-start progress per tick
    segments_per_round: int = 1    # per-device fill budget inside one round
    recovery_ticks: int = 2        # service pause: crash -> rejoined chain
    epoch_budget: int = 4          # adapter epoch budget per server
    migrate_on_crash: bool = True  # KV-snapshot migration to survivors
    # (False = legacy re-prefill re-route; kept as the bench baseline)
    partial_recovery: str = "reconstruct"  # partial-crash mode:
    # "reconstruct" = rebuild dead layers in place, stage plan unchanged
    # (the original mode); "repartition" = elastic re-split of the pipeline
    # over the survivors (engine.repartition + one-scatter relay_inflight)
    repartition_ticks: int = 1     # service pause for a repartition — the
    # re-split reuses resident segments, so dispatch prices it cheaper
    # than the reconstruct pause (recovery_ticks)
    unservable_retries: int = 3    # placement-miss rechecks before the
    # "unservable" event fires (exponential backoff between rechecks)
    retry_backoff_s: float = 0.2   # first backoff; doubles per attempt
    multicast: Optional[MulticastConfig] = None  # peer-to-peer scale-out:
    # spawned servers pull their model copy from warm peers over ICI
    # (cluster/multicast.py) instead of each reading from host; None =
    # legacy host-only cold starts
    prefix_cache_bytes: int = 0    # per-server cross-request prefix cache
    # budget (serving/prefix_cache.py): admissions import cached prompt-
    # prefix KV and prefill only the suffix; 0 = off (legacy behaviour).
    # Pair with a router-level StateTier to keep the cache across
    # idle-retire/respawn cycles (the fleet state tier)


class ClusterServer:
    """One autoscaled GPU-server replica.

    Not ported yet (see ROADMAP.md): the pipeline prefill.  The reference
    wires it only where ``enable_pipeline_prefill`` finds two or more XLA
    devices (``repro/cluster/router.py:140-147``); on one device, and so
    here, the batcher keeps its single prefill."""

    def __init__(self, sid: int, cfg: ArchConfig, params, ccfg: ClusterConfig,
                 adapter_params: Optional[Dict[str, Any]] = None):
        self.sid = sid
        self.ccfg = ccfg
        self.engine = PipeBoostEngine(cfg, params, n_devices=ccfg.n_devices,
                                      max_len=ccfg.max_len,
                                      segments_per_round=ccfg.segments_per_round)
        self.srv = ServingEngine(
            cfg, params, n_slots=ccfg.n_slots, max_len=ccfg.max_len,
            policy=EpochSchedulerPolicy(epoch_budget=ccfg.epoch_budget,
                                        max_batch=ccfg.n_slots),
            adapter_params=adapter_params or {})
        self.srv.batcher.sampler = quantized_greedy
        self.state = "loading"
        self.idle_ticks = 0
        self.idle_since: Optional[float] = None  # clock time idleness began
        self.served_while_loading = False   # admitted before fully loaded
        self.spawned_at = 0.0               # router stamps these in router
        self.ready_at: Optional[float] = None       # clock seconds
        self.fully_loaded_at: Optional[float] = None
        self._recover_left = 0
        self._ready_est: Optional[tuple] = None  # (now, s) rounds_to_ready
        self.last_recovery: Dict[str, float] = {}  # partial-crash rebuild
        # stats (kv_reconstruct work counts); read by the router right
        # after crash(), reset only at this server's next crash()
        self.recovery_mode: Optional[str] = None  # how the last partial
        # crash was handled ("reconstruct" | "repartition")
        # multicast scale-out: the router attaches a MulticastManager when
        # ClusterConfig.multicast is set; fill then arrives as peer
        # deliveries instead of host load rounds (until the copy lands)
        self._mc = None
        # fleet state tier: modeled seconds the spawn-time resurrect pull
        # takes (0 = cold spawn); overlaps the weight fill, priced into
        # predicted_ready_s so dispatch sees it
        self.resurrect_cost_s = 0.0

    # ---- state-tier surface ----------------------------------------------
    def attach_prefix_cache(self, cache) -> None:
        """Give this server's batcher a cross-request prefix cache (the
        router spawns one per server when
        ``ClusterConfig.prefix_cache_bytes`` is set)."""
        self.srv.attach_prefix_cache(cache)

    def predicted_prefix_tokens(self, req: ServeRequest) -> int:
        """Prompt tokens an admission of ``req`` would NOT re-prefill
        here (longest usable cached prefix; 0 without a cache) — the
        savings signal ``SloAware.prefix_bonus_s_per_token`` prices."""
        pc = self.srv.batcher.prefix_cache
        if pc is None:
            return 0
        return pc.match_len(self.srv.cfg.name, req.adapter,
                            np.asarray(req.tokens))

    def spill_state(self) -> Optional[Dict[str, Any]]:
        """Package warm state for the host tier at idle retirement: the
        prefix cache's entries (KV rows are already host numpy) plus the
        resident adapter params.  ``None`` when nothing warm is held —
        the router then retires without a spill."""
        pc = self.srv.batcher.prefix_cache
        entries = pc.export_entries() if pc is not None else []
        if not entries:
            return None
        return {"prefix_entries": entries,
                "adapters": dict(self.srv.adapter_params),
                "nbytes": int(sum(e.nbytes for _, e in entries))}

    def resurrect_from(self, bundle: Dict[str, Any],
                       cost_s: float = 0.0) -> int:
        """Seed this freshly spawned server from a spilled bundle:
        prefix entries merge into the attached cache, spilled adapters
        preload (widening ``can_serve``), and the modeled pull time is
        kept so dispatch prices readiness.  Returns entries admitted."""
        pc = self.srv.batcher.prefix_cache
        n = 0
        if pc is not None:
            n = pc.import_entries(bundle.get("prefix_entries", ()))
        for name, params in bundle.get("adapters", {}).items():
            self.srv.adapter_params.setdefault(name, params)
        self.resurrect_cost_s = max(self.resurrect_cost_s, cost_s)
        return n

    # ---- multicast surface ------------------------------------------------
    def mc_seg_bytes(self) -> List[int]:
        """Per-segment byte sizes of one model copy, in load-plan order —
        what the ``MulticastManager`` streams from peers."""
        return [s.bytes for s in self.engine.plan.segments]

    def mc_attach(self, manager) -> None:
        """Switch this server's cold-start fill to multicast deliveries
        (host load rounds pause until the peer copy has fully landed)."""
        self._mc = manager

    def mc_deliver(self, segments: Sequence[int]) -> None:
        """Materialise segments a peer finished streaming this tick: each
        lands on its serve-assignment owner device via the engine's
        targeted ``load_segment`` (tagged ``source="peer"``)."""
        for seg in sorted(segments):
            dev = self._mc_owner(seg)
            if dev is not None:
                self.engine.load_segment(dev, seg, source="peer")

    def _mc_owner(self, seg: int) -> Optional[int]:
        """Alive device that serves ``seg`` under the current plan (lowest
        alive device when the owner died mid-fill; None = all dead)."""
        alive = {d.idx for d in self.engine.devices if d.alive}
        for dev, segs in self.engine.plan.serve_assignment.items():
            if seg in segs and dev in alive:
                return dev
        return min(alive) if alive else None

    @property
    def mc_active_sends(self) -> int:
        """Outbound multicast transfers this server is sourcing (0 when
        multicast is off) — priced by ``SloAware.source_penalty_s``."""
        return 0 if self._mc is None else self._mc.active_sends(self.sid)

    # ---- scheduling surface ----------------------------------------------
    @property
    def admitting(self) -> bool:
        return self.state == "serving"

    @property
    def load(self) -> int:
        return self.srv.n_pending

    @property
    def needs_tick(self) -> bool:
        """Would a tick do real work on this server?  False == quiescent:
        the event engine may jump the clock past it.  Loading/recovering
        servers always progress per tick; a serving server progresses
        while it has pending/in-flight requests or background fill left.
        (A fully-loaded idle server's tick only bumps idle counters — the
        idle-retire *deadline* replaces that under the event engine.)"""
        if self.state in ("down", "retired"):
            return False
        if self.state in ("loading", "recovering"):
            return True
        return bool(self.srv.n_pending) or not self.engine.fully_loaded

    def can_serve(self, req: ServeRequest) -> bool:
        """Does this server hold the weights the request needs?  Placement
        may have preloaded only a subset of the pool's adapters."""
        return req.adapter is None or req.adapter in self.srv.adapter_params

    @property
    def degraded_devices(self) -> int:
        """Dead devices on a server still in the fleet — the capacity a
        repartitioned server keeps *not* having (metrics accrue
        ``degraded_seconds`` off this, per tick)."""
        if self.state in ("down", "retired"):
            return 0
        return sum(1 for d in self.engine.devices if not d.alive)

    def predicted_ready_s(self, now: float) -> float:
        """Predicted seconds until this server can admit (0 when serving).

        Loading servers estimate off the engine's load-plan progress
        (``rounds_to_ready`` — cold-start progress, the signal
        ``EngineStatus.time_to_ready`` stamps once it flips); recovering
        servers off the remaining recovery ticks.  Down/retired servers
        are never admittable (+inf).

        The load-plan simulation only changes when ``load_round`` runs
        (once per tick), and dispatch evaluates every (request, server)
        pair against one tick's ``now`` — so the estimate is cached per
        ``now`` instead of re-simulated per queue entry."""
        if self.state == "serving":
            return 0.0
        if self.state == "loading":
            if self._ready_est is None or self._ready_est[0] != now:
                rounds = self.engine.rounds_to_ready()
                ticks = math.ceil(rounds
                                  / max(1, self.ccfg.load_rounds_per_tick))
                self._ready_est = (now, ticks * self.ccfg.tick_s)
            est = self._ready_est[1]
            if self.resurrect_cost_s:
                # the state-tier pull overlaps the weight fill; it only
                # extends readiness when it outlasts the remaining load
                est = max(est, self.spawned_at + self.resurrect_cost_s - now)
            return est
        if self.state == "recovering":
            return max(0, self._recover_left) * self.ccfg.tick_s
        return math.inf

    @property
    def oldest_queued_arrival(self) -> Optional[float]:
        """Earliest arrival among requests queued here without a first
        token yet (feeds the autoscaler's TTFT-SLO signal)."""
        waiting = [r.arrival for r in self.srv.queued_requests()
                   if r.first_token_at is None]
        return min(waiting) if waiting else None

    def submit(self, req: ServeRequest) -> None:
        """Hand a dispatched request to this server's serving engine."""
        self.srv.submit(req)

    # ---- lifecycle --------------------------------------------------------
    def tick(self, now: float) -> List[ServeRequest]:
        """Advance one router tick; returns requests finished this tick."""
        if self.state == "loading":
            # under multicast the copy streams in from peers (delivered by
            # the router pre-tick); host rounds stay paused until it lands,
            # then resume for replication.  receiver_done is True for
            # unknown sids, so a detached/foreign server self-heals to host.
            if self._mc is None or self._mc.receiver_done(self.sid):
                for _ in range(self.ccfg.load_rounds_per_tick):
                    self.engine.load_round()
            if not self.engine.ready:
                return []
            # viable chain => serve THIS tick (the overlap: the queue
            # starts draining the moment ready flips, not a tick later;
            # background fill of the remaining segments continues below)
            self.state = "serving"
            self.ready_at = now
        if self.state == "recovering":
            self._recover_left -= 1
            if self._recover_left <= 0:
                if self.recovery_mode != "repartition":
                    # re-plan + reload to a viable chain; a repartition
                    # already did both synchronously inside crash()
                    self.engine.recover()
                self.state = "serving"
            return []
        if self.state in ("down", "retired"):
            return []
        # serving: background fill until full, then the §4.3.3 switch
        if not self.engine.fully_loaded:
            if self._mc is None or self._mc.receiver_done(self.sid):
                self.engine.load_round()
            if self.srv.n_pending:
                self.served_while_loading = True
        elif self.engine.strategy == "pipeline":
            # crossover policy: switch to per-device serving as soon as the
            # full model is resident (rate-based crossover is a future knob)
            self.engine.maybe_switch_strategy(request_rate=0.0)
        if self.fully_loaded_at is None and self.engine.fully_loaded:
            self.fully_loaded_at = now
        done = self.srv.step(now=now)
        if self.srv.n_pending:
            self.idle_ticks = 0
            self.idle_since = None
        else:
            self.idle_ticks += 1
            if self.idle_since is None:
                self.idle_since = now  # retire deadline = idle_since + idle_s
        return done

    def cold_start_record(self) -> Dict[str, Any]:
        """Per-server cold-start accounting (logical clock + the engine's
        wall-clock/byte accounting) for the cluster metrics JSON."""
        eng = self.engine.cold_start_stats()
        rdy = self.ready_at
        ful = self.fully_loaded_at
        # clamp: under a wall clock the spawn stamp can land microseconds
        # after the tick's ``now`` capture
        return {
            "server": self.sid,
            "time_to_ready": (None if rdy is None
                              else max(0.0, rdy - self.spawned_at)),
            "time_to_fully_loaded": (None if ful is None
                                     else max(0.0, ful - self.spawned_at)),
            "served_while_loading": self.served_while_loading,
            "wall_time_to_ready": eng["time_to_ready"],
            "wall_time_to_fully_loaded": eng["time_to_fully_loaded"],
            "loaded_bytes": eng["loaded_bytes"],
            "total_bytes": eng["total_bytes"],
            "n_rounds": eng["n_rounds"],
        }

    def crash(self, device_ids: Optional[Sequence[int]] = None
              ) -> List[ServeRequest]:
        """Kill devices (all of them by default).

        Whole-server crash: hands back every in-flight + queued request
        for cross-server re-routing; in-flight requests carry their
        ``KVSnapshot`` so survivors can resume them without re-prefill.

        Partial crash (survivors remain): the server keeps its requests.
        Under ``partial_recovery="reconstruct"`` only the layers whose
        KV/state lived on the dead devices are rebuilt in place via
        ``reconstruct_cache`` (Q-only recompute for attention layers whose
        KV survived, §4.4.2), stage plan unchanged.  Under
        ``"repartition"`` the engine elastically re-splits the pipeline
        over the survivors (``engine.repartition``) and the live batch is
        re-laid in ONE donated scatter (``relay_inflight``) — the service
        pause is the shorter ``repartition_ticks``.  Work stats land in
        ``last_recovery`` for the router's metrics.  Returns [].
        """
        ids = (list(device_ids) if device_ids is not None
               else [d.idx for d in self.engine.devices])
        # the cached rounds-to-ready estimate described the pre-crash load
        # plan; scoring a post-crash server with it would let SloAware
        # route onto a chain that no longer exists
        self._ready_est = None
        dead = set(ids)
        survivors = [d.idx for d in self.engine.devices
                     if d.alive and d.idx not in dead]
        self.last_recovery = {}
        self.recovery_mode = None
        if not survivors:
            drained = self.srv.drain_inflight(
                export_state=self.ccfg.migrate_on_crash)
            self.engine.crash(ids)
            self.state = "down"
            return drained
        lost = self.engine.lost_state_layers(ids)   # before devices die
        if self.ccfg.partial_recovery == "repartition":
            self.engine.repartition(dead=ids)   # crash + re-split + reload
            if any(lost):
                self.last_recovery = self.srv.relay_inflight(
                    [not l for l in lost])
            self.recovery_mode = "repartition"
            self.state = "recovering"
            self._recover_left = self.ccfg.repartition_ticks
            return []
        self.engine.crash(ids)
        if any(lost):
            self.last_recovery = self.srv.reconstruct_inflight(
                [not l for l in lost])
        self.recovery_mode = "reconstruct"
        self.state = "recovering"
        self._recover_left = self.ccfg.recovery_ticks
        return []

    def rejoin(self) -> None:
        """Reboot a fully-down server back into the fleet (fresh cold
        start through the pipelined loader)."""
        self.engine.restart()
        self.state = "loading"
        self.ready_at = None
        self.fully_loaded_at = None
        self.served_while_loading = False
        self._ready_est = None   # estimate belongs to the pre-crash plan

    def rejoin_devices(self, device_ids: Sequence[int]) -> None:
        """Device-granular rejoin on a LIVE server: dead devices come back
        empty and the stage plan widens over them.  Under
        ``partial_recovery="repartition"`` the engine re-splits in flight
        (in-flight requests keep decoding bit-identically); otherwise the
        devices just revive into the existing plan.  Either way the
        serving tick's background ``load_round`` refills them, since
        ``fully_loaded`` flips back to False."""
        self._ready_est = None
        if self.ccfg.partial_recovery == "repartition":
            self.engine.repartition(revive=list(device_ids))
        else:
            self.engine.revive(list(device_ids))

    def retire(self) -> List[ServeRequest]:
        """Voluntary scale-down: drain and hand back any leftovers (they
        re-queue through dispatch), then leave the fleet for good.  The
        batcher's device state (cache, owned adapter leaves, captured
        decode step) is freed; the object stays for the router's records."""
        leftovers = self.srv.drain_inflight(export_state=False)
        self.srv.batcher.release()
        self.state = "retired"
        return leftovers


class ClusterRouter:
    """Trace replay + queue + server lifecycle + crash handling; scheduling
    decisions delegate to the injected dispatch/placement policies."""

    def __init__(self, cfg: ArchConfig, params, *, n_servers: int = 2,
                 ccfg: Optional[ClusterConfig] = None,
                 autoscaler: Optional[Autoscaler] = None,
                 adapter_params: Optional[Dict[str, Any]] = None,
                 metrics: Optional[ClusterMetrics] = None,
                 dispatch: Optional[DispatchPolicy] = None,
                 placement: Optional[PlacementPolicy] = None,
                 clock: Optional[Clock] = None,
                 model: Optional[str] = None,
                 rid_counter: Optional[itertools.count] = None,
                 server_factory=None,
                 materialize_prompts: bool = True,
                 state_tier: Optional[StateTier] = None):
        self.cfg = cfg
        self.params = params
        self.ccfg = ccfg or ClusterConfig()
        self.autoscaler = autoscaler
        self.adapter_params = adapter_params
        self.metrics = metrics or ClusterMetrics()
        self.dispatch = dispatch or LeastLoaded()
        self.placement = placement or PreloadAll()
        self._clock: Clock = clock or LogicalClock()
        self.metrics.clock = self._clock
        self.model = model                  # pool name in a multi-model fleet
        # pluggable backend: ``server_factory(sid, cfg, params, ccfg,
        # adapters) -> ClusterServer-like`` swaps the JAX-backed server for
        # a modeled one (cluster/simserver.py) in full-day trace replays
        self.server_factory = server_factory or ClusterServer
        # False skips per-request prompt RNG materialization (a modeled
        # backend never reads the token values; million-row replays skip
        # one rng construction per arrival)
        self.materialize_prompts = materialize_prompts
        self.servers: List[ClusterServer] = []
        self.queue: Deque[ServeRequest] = deque()
        self._recent_adapters: Deque[str] = deque(maxlen=256)
        self._prev_tick_t: Optional[float] = None
        self._unservable_flagged: set = set()   # rids already evented
        self._unchecked: List[ServeRequest] = []  # new since last scan
        self._recheck_unservable = False        # fleet changed: rescan all
        # bounded-retry state for placement misses: rid -> (failed
        # attempts, clock time of the next recheck); the "unservable"
        # event only fires once the retries are exhausted
        self._retry_state: Dict[int, tuple] = {}
        self._stuck_ticks = 0                   # liveness: no-progress run
        # a fleet shares one rid counter across pools so metrics keys are
        # globally unique; standalone routers own theirs
        self._rid = rid_counter if rid_counter is not None else \
            itertools.count()
        # peer-to-peer multicast scale-out (cluster/multicast.py): every
        # spawned server registers as a receiver, warm peers relay
        self.multicast = (MulticastManager(self.ccfg.multicast)
                          if self.ccfg.multicast is not None else None)
        # fleet state tier (cluster/state_tier.py): idle retirements spill
        # warm prefix-cache/adapter state here; later spawns for the same
        # pool resurrect it.  Shared fleet-wide; None = legacy discard
        self.state_tier = state_tier
        for _ in range(n_servers):
            self.spawn_server()

    @property
    def clock(self) -> float:
        """Current router time in seconds (reads the injected clock)."""
        return self._clock.now()

    def _metrics_sid(self, sid: int):
        """Server key in shared (cross-pool) metrics stores."""
        return f"{self.model}/{sid}" if self.model is not None else sid

    # ---- fleet ops --------------------------------------------------------
    def spawn_server(self) -> ClusterServer:
        """Cold-start one server via ``server_factory``, preloading the
        adapter subset the placement policy picks from recent traffic."""
        aps = self.placement.adapters_for(self.adapter_params or {},
                                          list(self._recent_adapters))
        s = self.server_factory(len(self.servers), self.cfg, self.params,
                                self.ccfg, aps)
        s.spawned_at = self.clock
        self.servers.append(s)
        if (self.ccfg.prefix_cache_bytes > 0
                and hasattr(s, "attach_prefix_cache")):
            s.attach_prefix_cache(PrefixCache(self.ccfg.prefix_cache_bytes))
        if self.state_tier is not None and hasattr(s, "resurrect_from"):
            bundle = self.state_tier.take(self.model)
            if bundle is not None:
                # price the host->device pull: concurrent resurrect
                # streams share the aggregate host bandwidth, exactly
                # like simultaneous host cold-start fills
                hw = (self.ccfg.multicast.hw
                      if self.ccfg.multicast is not None else GPU_PAPER)
                concurrent = 1 + sum(
                    1 for x in self.servers
                    if x is not s and x.state == "loading"
                    and getattr(x, "resurrect_cost_s", 0.0) > 0.0
                    and self.clock - x.spawned_at < x.resurrect_cost_s)
                cost = state_resurrect_time(int(bundle.get("nbytes", 0)),
                                            hw, concurrent)
                n_ent = s.resurrect_from(bundle, cost_s=cost)
                self.metrics.on_event(
                    self.clock, "resurrect",
                    f"server{self._metrics_sid(s.sid)} entries={n_ent} "
                    f"bytes={bundle.get('nbytes', 0)} "
                    f"modeled_pull={cost:.3f}s")
        if self.multicast is not None and hasattr(s, "mc_seg_bytes"):
            self.multicast.register_receiver(s.sid, s.mc_seg_bytes())
            s.mc_attach(self.multicast)
        self._recheck_unservable = True
        self.metrics.on_event(self.clock, "spawn",
                              f"server{self._metrics_sid(s.sid)} "
                              f"adapters={sorted(aps)}")
        return s

    def crash_server(self, sid: int,
                     device_ids: Optional[Sequence[int]] = None) -> None:
        """Crash a server and recover its work, cheapest mode first.

        Whole-server crash: each in-flight request's ``KVSnapshot``
        migrates to a survivor with a free slot (``admit_with_state`` —
        zero prompt tokens re-prefilled); requests no survivor can take
        fall back to the queue and re-prefill on admission (the legacy
        path, also the behaviour when ``migrate_on_crash`` is off).
        Partial crash: the server rebuilds only its dead layers in place
        (``reconstruct_cache``) and keeps serving; nothing re-routes.
        Per-mode counts and token savings land in the metrics' recovery
        counters.
        """
        server = self.servers[sid]
        drained = server.crash(device_ids)
        if self.multicast is not None and server.state == "down":
            # the victim leaves the multicast tree: its inbound transfer
            # dies with it and every transfer it was sourcing re-roots
            # onto surviving holders (receivers resume, never restart)
            self.multicast.remove(sid)
        if getattr(server, "recovery_mode", None) == "repartition":
            # in-place elastic re-split: every live request stays put with
            # its whole decoded prefix — count each as repartition-
            # recovered (zero tokens re-prefilled, zero migrated off)
            if server.last_recovery:
                self.metrics.on_relay(server.last_recovery)
            n_rep = 0
            for _, req in sorted(server.srv.batcher.active.items()):
                self.metrics.on_recovery(
                    "repartition", req.rid,
                    len(req.tokens) + max(0, len(req.generated) - 1))
                n_rep += 1
            self.metrics.on_event(
                self.clock, "recover",
                f"server{self._metrics_sid(sid)} repartition reqs={n_rep} "
                f"relayed={server.last_recovery.get('relayed_reqs', 0):.0f} "
                f"kv_reused={server.last_recovery.get('kv_reused', 0):.0f} "
                f"full_prefill="
                f"{server.last_recovery.get('full_prefill', 0):.0f}")
        elif server.last_recovery:
            self.metrics.on_reconstruct(server.last_recovery)
            self.metrics.on_event(
                self.clock, "recover",
                f"server{self._metrics_sid(sid)} reconstruct "
                f"reqs={server.last_recovery.get('reconstructed_reqs', 0):.0f} "
                f"kv_reused={server.last_recovery.get('kv_reused', 0):.0f} "
                f"full_prefill={server.last_recovery.get('full_prefill', 0):.0f}")
        migrated = reprefilled = 0
        leftovers: List[ServeRequest] = []
        mid_decode: List[ServeRequest] = []
        for req in drained:
            if not req.generated:          # queued-only: plain re-dispatch
                req.snapshot = None
                leftovers.append(req)
            else:
                mid_decode.append(req)
        # Batched migration: survivors absorb victims least-loaded-first,
        # each taking as many snapshots as it has free slots in ONE donated
        # scatter (admit_with_state_batch) — not one import dispatch per
        # victim.  Requests no survivor can take fall back to re-prefill.
        n_state = {req.rid: (req.snapshot.pos if req.snapshot is not None
                             else 0) for req in mid_decode}
        accepted_ids = set()
        if self.ccfg.migrate_on_crash:
            pending = [r for r in mid_decode if r.snapshot is not None]
            cands = [s for s in self.servers
                     if s.admitting and s.srv.batcher.free]
            for s in sorted(cands, key=lambda s: (s.load, s.sid)):
                if not pending:
                    break
                # offer the whole backlog: the importer itself caps at its
                # free slots, and slicing here would let epoch-barrier
                # rejects starve migratable requests behind them
                s.srv.clock = max(s.srv.clock, self.clock)
                for r in s.srv.admit_with_state_batch(pending):
                    accepted_ids.add(r.rid)
                pending = [r for r in pending if r.rid not in accepted_ids]
        for req in mid_decode:
            self.metrics.on_reroute(req.rid)   # mid-decode: moved servers
            if req.rid in accepted_ids:
                migrated += 1
                self.metrics.on_recovery("migrate", req.rid,
                                         n_state[req.rid])
            else:
                req.snapshot = None        # state lost: re-prefill path
                reprefilled += 1
                self.metrics.on_recovery(
                    "reprefill", req.rid,
                    len(req.tokens) + len(req.generated))
                leftovers.append(req)
        self.metrics.on_event(self.clock, "crash",
                              f"server{self._metrics_sid(sid)} migrated={migrated} "
                              f"reprefilled={reprefilled} "
                              f"requeued={len(leftovers) - reprefilled}")
        for req in reversed(leftovers):
            self.queue.appendleft(req)
        self._recheck_unservable = True

    def rejoin_server(self, sid: int,
                      device_ids: Optional[Sequence[int]] = None) -> None:
        """Reboot a downed server into the fleet (fresh cold start; its
        spawn stamp resets so cold-start metrics track the reboot) — or,
        with ``device_ids`` on a LIVE server, rejoin just those devices
        (``ClusterServer.rejoin_devices``: the pipeline widens back
        without draining).  A retired server never rejoins: retirement is
        final (the race with a scheduled rejoin resolves to a no-op,
        surfaced as a ``rejoin_skipped`` event)."""
        server = self.servers[sid]
        if server.state == "retired":
            self.metrics.on_event(self.clock, "rejoin_skipped",
                                  f"server{self._metrics_sid(sid)} retired")
            return
        if device_ids is not None and server.state != "down":
            server.rejoin_devices(device_ids)
            self._recheck_unservable = True
            self.metrics.on_event(self.clock, "rejoin",
                                  f"server{self._metrics_sid(sid)} "
                                  f"devices={sorted(device_ids)}")
            return
        server.rejoin()
        server.spawned_at = self.clock
        if self.multicast is not None and hasattr(server, "mc_seg_bytes"):
            # the reboot is a fresh receiver: it re-enters the multicast
            # tree with an empty segment set and fills from warm peers
            self.multicast.register_receiver(sid, server.mc_seg_bytes())
            server.mc_attach(self.multicast)
        self._recheck_unservable = True
        self.metrics.on_event(self.clock, "rejoin",
                              f"server{self._metrics_sid(sid)}")

    # ---- request path -----------------------------------------------------
    def submit(self, arrival: Arrival) -> int:
        """Turn one trace ``Arrival`` into a queued ``ServeRequest``
        (prompt materialized or stubbed, absolute deadline stamped) and
        open its metrics record; returns the assigned rid."""
        if arrival.adapter and arrival.adapter not in (
                self.adapter_params or {}):
            raise ValueError(
                f"trace names adapter {arrival.adapter!r} but the router "
                f"has adapter_params for {sorted(self.adapter_params or {})}")
        rid = next(self._rid)
        if self.materialize_prompts:
            toks = prompt_tokens(arrival, self.cfg.vocab_size)
        else:
            toks = _prompt_stub(arrival.prompt_len)
        req = ServeRequest(rid, toks,
                           max_new_tokens=arrival.max_new_tokens,
                           adapter=arrival.adapter, arrival=arrival.time,
                           model=arrival.model or self.model,
                           deadline=(None if arrival.ttft_deadline_s is None
                                     else arrival.time
                                     + arrival.ttft_deadline_s))
        if arrival.adapter:
            self._recent_adapters.append(arrival.adapter)
        self.metrics.on_submit(rid, arrival.time, model=req.model,
                               deadline=req.deadline)
        self.queue.append(req)
        self._unchecked.append(req)
        return rid

    def _dispatch(self, now: Optional[float] = None) -> None:
        # capacity-bounded: hand a server at most n_slots outstanding
        # requests; the backlog stays in the router queue so a server that
        # cold-starts mid-burst absorbs it (and the queue's wait keeps
        # feeding the autoscaler's SLO signal).  The (request, server)
        # pairing itself is the injected policy's call.
        if now is None:
            now = self.clock
        # visibility: a request no provisioned server can serve (placement
        # preloaded subsets) is skipped by the policies, not dispatched —
        # surfaced once per request, after a bounded number of backoff-
        # spaced rechecks (the fleet may still spawn/rejoin a server that
        # preloads it).  Lazy: only requests queued since the last scan are
        # checked, plus requests whose backoff deadline passed, plus one
        # full rescan whenever the fleet composition changes (spawn /
        # crash / rejoin / retire) — not O(queue) every tick.
        live = [s for s in self.servers
                if s.state not in ("down", "retired")]
        to_check = (list(self.queue) if self._recheck_unservable
                    else list(self._unchecked))
        if self._retry_state:
            due = {rid for rid, (_, t_due) in self._retry_state.items()
                   if t_due <= now + 1e-9}
            if due:
                seen = {r.rid for r in to_check}
                to_check.extend(r for r in self.queue
                                if r.rid in due and r.rid not in seen)
        for req in to_check:
            if req.rid in self._unservable_flagged:
                continue
            if any(s.can_serve(req) for s in live):
                self._retry_state.pop(req.rid, None)  # servable again
                continue
            n, t_due = self._retry_state.get(req.rid, (0, -math.inf))
            if t_due > now + 1e-9:
                continue               # backoff not elapsed: recheck later
            n += 1
            if n > self.ccfg.unservable_retries:
                self._retry_state.pop(req.rid, None)
                self._unservable_flagged.add(req.rid)
                self.metrics.on_event(
                    now, "unservable",
                    f"req{req.rid} adapter={req.adapter!r}: no live server "
                    f"preloads it after {self.ccfg.unservable_retries} "
                    "retries (placement)")
            else:
                delay = self.ccfg.retry_backoff_s * (2 ** (n - 1))
                self._retry_state[req.rid] = (n, now + delay)
                self.metrics.on_event(
                    now, "retry",
                    f"req{req.rid} adapter={req.adapter!r} attempt "
                    f"{n}/{self.ccfg.unservable_retries} "
                    f"next_check=+{delay:.2f}s")
        self._unchecked = []
        self._recheck_unservable = False
        if not hasattr(self.dispatch, "select_many"):
            # compatibility: a select-only third-party policy dispatches
            # one request per call, exactly the pre-batching loop
            while self.queue:
                picked = self.dispatch.select(self.queue, self.servers, now,
                                              self.ccfg)
                if picked is None:
                    return
                idx, target = picked
                req = self.queue[idx]
                del self.queue[idx]
                target.srv.clock = max(target.srv.clock, now)
                target.submit(req)
            return
        while self.queue:
            # one batched round: the policy pairs every placeable request
            # in a single queue sort + scoring sweep (virtual load
            # accounting keeps it equivalent to the repeated-select loop)
            picks = self.dispatch.select_many(self.queue, self.servers, now,
                                              self.ccfg)
            if not picks:
                return
            reqs = list(self.queue)
            taken = set()
            for idx, target in picks:
                req = reqs[idx]
                taken.add(idx)
                # sync the server clock so dispatch stamps are router time
                target.srv.clock = max(target.srv.clock, now)
                target.submit(req)
            if len(taken) == len(reqs):
                self.queue.clear()
            else:
                self.queue = deque(r for j, r in enumerate(reqs)
                                   if j not in taken)

    @property
    def pending(self) -> int:
        return len(self.queue) + sum(s.load for s in self.servers)

    def stalled(self, arrivals_left: bool, patience: int = 500) -> bool:
        """Liveness guard for ``run``-style loops: True once the router
        has spent ``patience`` consecutive ticks with work stuck in the
        router queue, nothing in flight, no future arrivals, and no
        server mid-cold-start/recovery — i.e. no event left that could
        ever dispatch the remainder (requests whose adapter no
        provisioned server preloads).  Without this, an unservable
        request would spin the replay loop to ``max_ticks`` silently."""
        stuck = (not arrivals_left and self.pending > 0
                 and self.pending == len(self.queue)
                 and not any(s.state in ("loading", "recovering")
                             for s in self.servers))
        self._stuck_ticks = self._stuck_ticks + 1 if stuck else 0
        if self._stuck_ticks == patience + 1:   # event once, at the crossing
            self.metrics.on_event(
                self.clock, "starved",
                f"{len(self.queue)} request(s) undispatchable "
                f"(no server can serve them); giving up the replay")
        return self._stuck_ticks > patience

    # ---- main loop --------------------------------------------------------
    def tick(self, *, advance: bool = True,
             now: Optional[float] = None) -> List[ServeRequest]:
        """One cluster tick: autoscale, dispatch, advance every server.

        ``advance=False`` leaves the clock alone — a multi-pool fleet
        ticks every pool against the shared clock, then advances it once;
        the fleet also freezes one ``now`` for all pools so their samples
        share a timestamp even under a wall clock.
        """
        if now is None:
            now = self.clock
        if self.autoscaler is not None:
            # head-of-line wait spans the router queue AND requests still
            # queued inside servers (dispatch drains the router queue every
            # tick, so server-side waiters carry the TTFT-SLO signal)
            waits = [r.arrival for r in self.queue]
            waits += [a for s in self.servers
                      if s.state not in ("down", "retired")
                      and (a := s.oldest_queued_arrival) is not None]
            oldest = now - min(waits) if waits else 0.0
            d = self.autoscaler.decide(now, self.pending, oldest,
                                       self.servers, tick_s=self.ccfg.tick_s)
            for _ in range(d.spawn):
                self.metrics.on_event(now, "scale_up", "")
                self.spawn_server()
            for sid in d.retire:
                self.metrics.on_event(now, "retire",
                                      f"server{self._metrics_sid(sid)}")
                victim = self.servers[sid]
                if (self.state_tier is not None
                        and hasattr(victim, "spill_state")):
                    # idle scale-down keeps the warm state: prefix-cache
                    # rows + resident adapters spill to the host tier
                    # instead of dying with the replica
                    bundle = victim.spill_state()
                    if bundle is not None:
                        self.state_tier.spill(self.model, bundle)
                        self.metrics.on_event(
                            now, "spill",
                            f"server{self._metrics_sid(sid)} "
                            f"bytes={bundle['nbytes']} "
                            f"entries={len(bundle['prefix_entries'])}")
                self.queue.extend(victim.retire())
                if self.multicast is not None:
                    self.multicast.remove(sid)
                self._recheck_unservable = True
        self._dispatch(now)
        if self.multicast is not None:
            # advance peer transfers one tick and hand completed segments
            # to their receivers BEFORE the servers tick — a copy that
            # completes this tick flips ready and serves this same tick
            # (the overlapped cold start, fed over ICI instead of host)
            for msid, segs in self.multicast.advance(
                    now, self.ccfg.tick_s).items():
                self.servers[msid].mc_deliver(segs)
        finished: List[ServeRequest] = []
        for s in self.servers:
            was_loading = s.state == "loading"
            for r in s.tick(now):
                self.metrics.on_first_token(r.rid, r.first_token_at)
                self.metrics.on_finish(r.rid, r.finished_at,
                                       len(r.generated),
                                       self._metrics_sid(s.sid))
                finished.append(r)
            if was_loading and s.state == "serving":
                # scale-up latency = time-to-first-admittable, NOT
                # time-to-fully-loaded: the autoscaler's new capacity is
                # live from this moment while segments keep streaming in
                self.metrics.on_event(
                    now, "ready",
                    f"server{self._metrics_sid(s.sid)} time_to_ready="
                    f"{max(0.0, now - s.spawned_at):.2f}s "
                    f"loaded_bytes={s.engine.loaded_bytes()}")
        busy = sum(self.ccfg.n_devices for s in self.servers
                   if s.state not in ("down", "retired"))
        # GPU-seconds accrue over the REAL tick duration: under the logical
        # clock that's exactly tick_s; under the wall clock it's whatever
        # time the tick actually took (same code, no clock branch)
        dt = (self.ccfg.tick_s if self._prev_tick_t is None
              else max(0.0, now - self._prev_tick_t))
        self._prev_tick_t = now
        # degraded capacity: dead devices on servers that kept serving
        # (repartition mode) accrue device-seconds the fleet is short
        degraded = sum(getattr(s, "degraded_devices", 0)
                       for s in self.servers)
        if degraded:
            self.metrics.degraded_seconds += degraded * dt
        self.metrics.on_tick(now, self.pending, len(
            [s for s in self.servers if s.state not in ("down", "retired")]),
            busy, dt)
        if advance:
            self._clock.advance(self.ccfg.tick_s)
        return finished

    @property
    def quiescent(self) -> bool:
        """True when no tick would do any work: empty router queue and no
        server mid-load/-recovery/-decode/-fill.  The event engine only
        jumps the clock while this holds (a dense tick is a provable no-op
        then, so skipping it cannot change any token stream)."""
        return not self.queue and not any(s.needs_tick for s in self.servers)

    def next_event_time(self, next_arrival: Optional[float] = None,
                        extra: Sequence[float] = ()) -> Optional[float]:
        """Earliest lifecycle event that can wake a quiescent fleet: the
        next trace arrival, the autoscaler's idle-retire deadline, or a
        caller-scheduled instant (e.g. a crash-rejoin time).  ``None``
        means nothing will ever happen again."""
        cands = [t for t in extra if t is not None]
        if next_arrival is not None:
            cands.append(next_arrival)
        if self.autoscaler is not None:
            t = self.autoscaler.next_retire_time(self.servers,
                                                 self.ccfg.tick_s)
            if t is not None:
                cands.append(t)
        return min(cands) if cands else None

    def _settle_gap(self, t_wake: float) -> None:
        """Account a quiescent gap as if its idle ticks had run: GPU-
        seconds accrue at the current fleet composition up to the tick
        *before* the wake tick (the wake tick accrues its own ``tick_s``
        normally, exactly as under the polling loop)."""
        busy = sum(self.ccfg.n_devices for s in self.servers
                   if s.state not in ("down", "retired"))
        degraded = sum(getattr(s, "degraded_devices", 0)
                       for s in self.servers)
        lead = t_wake - self.ccfg.tick_s
        if self._prev_tick_t is not None and lead > self._prev_tick_t:
            self.metrics.gpu_seconds += busy * (lead - self._prev_tick_t)
            if degraded:
                self.metrics.degraded_seconds += \
                    degraded * (lead - self._prev_tick_t)
            self._prev_tick_t = lead

    def _jump_to(self, t_wake: float) -> None:
        """Event-engine clock jump across a quiescent gap: settle the
        skipped ticks' accounting, then move the clock — logical clocks
        teleport, wall clocks sleep instead of hot-polling."""
        self._settle_gap(t_wake)
        self._clock.sleep_until(t_wake)

    def _apply_chaos(self, ev) -> None:
        """Execute one ``ChaosEvent``.  Events that no longer make sense
        (crashing a down/retired server, rejoining a live one) resolve to
        deterministic no-ops surfaced as ``chaos_skip`` events, so a seeded
        schedule replays identically however the fleet evolved."""
        skip = None
        server = (self.servers[ev.server]
                  if 0 <= ev.server < len(self.servers) else None)
        if server is None:
            skip = "no such server"
        elif server.state == "retired":
            skip = "retired"
        elif ev.kind in ("crash", "partial_crash", "source_crash",
                         "fill_crash"):
            # the load-stage kinds (source_crash = a multicast source dies
            # mid-transfer, fill_crash = an in-flight receiver dies) are
            # whole-server crashes by intent: crash_server drops the victim
            # from the multicast tree, which re-roots its dependents
            if server.state == "down":
                skip = "already down"
            else:
                devices = (list(ev.devices)
                           if ev.kind == "partial_crash" and ev.devices
                           else None)
                self.crash_server(ev.server, devices)
                return
        elif ev.kind == "rejoin":
            if server.state == "down":
                self.rejoin_server(ev.server)
                return
            devs = getattr(getattr(server, "engine", None), "devices", [])
            dead = [d.idx for d in devs if not d.alive]
            want = [i for i in ev.devices if i in dead] or dead
            if ev.devices and want:
                self.rejoin_server(ev.server, want)
                return
            skip = "nothing to rejoin"
        else:
            skip = f"unknown kind {ev.kind!r}"
        self.metrics.on_event(
            self.clock, "chaos_skip",
            f"{ev.kind} server{self._metrics_sid(ev.server)}: {skip}")

    def run(self, trace, *, max_ticks: int = 200_000,
            crash_after_completions: Optional[int] = None,
            crash_server_id: int = 1,
            crash_devices: Optional[Sequence[int]] = None,
            rejoin_after_ticks: Optional[int] = None,
            chaos=None,
            engine: str = "event",
            collect_finished: bool = True) -> List[ServeRequest]:
        """Replay ``trace`` to completion; returns finished requests.

        ``trace`` may be a sequence of :class:`Arrival` (sorted here) or a
        time-ordered iterator (``traces.arrival_stream`` /
        ``iter_azure_trace``) — streamed arrivals are never materialized.

        ``engine="event"`` (default) jumps the clock across quiescent gaps
        to the next arrival / retire deadline / rejoin instant; while any
        work is in flight it processes every tick densely, so its token
        streams are identical to ``engine="tick"`` (the legacy poll-every-
        tick loop, kept as the equivalence oracle).

        ``crash_after_completions``: once that many requests completed,
        crash ``crash_server_id`` (all its devices unless ``crash_devices``
        narrows it) and re-route its work; with ``rejoin_after_ticks`` the
        downed server reboots into the fleet that many ticks later.

        ``chaos``: a :class:`repro_torch.cluster.traces.ChaosSchedule` (or any
        iterable of ``ChaosEvent``) of scripted crash / partial-crash /
        rejoin faults.  Each event applies at the first tick whose
        pre-advance clock has reached its time — the arrival-admission
        rule — so a seeded schedule replays identically under both
        engines.

        ``collect_finished=False`` drops finished requests instead of
        returning them (million-row replays keep metrics, not payloads).
        """
        if engine not in ("event", "tick"):
            raise ValueError(f"unknown engine {engine!r}; "
                             "expected 'event' or 'tick'")
        stream = arrival_stream(trace)
        nxt = next(stream, None)
        tick_s = self.ccfg.tick_s
        completed: List[ServeRequest] = []
        n_completed = 0
        crashed = False
        chaos_left: Deque = deque(sorted(chaos or (),
                                         key=lambda e: e.time))
        # tick engine counts iterations; event engine schedules clock time
        rejoin_at: Optional[float] = None
        t = 0
        while t < max_ticks:
            while nxt is not None and nxt.time <= self.clock:
                self.submit(nxt)
                nxt = next(stream, None)
            while chaos_left and chaos_left[0].time <= self.clock:
                self._apply_chaos(chaos_left.popleft())
            if engine == "event" and self.quiescent:
                pending_rejoin = (rejoin_at is not None
                                  and self.servers[crash_server_id].state
                                  == "down")
                now = self.clock
                # the rejoin check below fires once the POST-advance clock
                # reaches rejoin_at (matching the tick engine's iteration
                # count), so the last dense tick it needs is the one AT
                # rejoin_at - tick_s — waking at rejoin_at itself would
                # reboot the server one tick late
                extra = [rejoin_at - tick_s] if pending_rejoin else []
                if chaos_left:
                    # chaos applies pre-tick against the pre-advance clock
                    # (the arrival rule): wake at the event time itself
                    extra.append(chaos_left[0].time)
                t_evt = self.next_event_time(
                    next_arrival=None if nxt is None else nxt.time,
                    extra=extra)
                if t_evt is None:
                    break           # nothing can ever wake the fleet again
                if t_evt - now > tick_s * 1e-6:
                    # jump to the first tick-grid point at/after the event
                    # (grid-aligned so the wake tick lands exactly where
                    # the polling loop would have processed the event)
                    k = max(1, math.ceil((t_evt - now) / tick_s - 1e-9))
                    k = min(k, max_ticks - t)
                    self._jump_to(now + k * tick_s)
                    t += k
                    continue
                # event is due now: process it as a normal dense tick
            done = self.tick()
            n_completed += len(done)
            if collect_finished:
                completed.extend(done)
            t += 1
            if (crash_after_completions is not None and not crashed
                    and n_completed >= crash_after_completions
                    and crash_server_id < len(self.servers)):
                self.crash_server(crash_server_id, crash_devices)
                crashed = True
                if rejoin_after_ticks is not None:
                    rejoin_at = (t - 1 + rejoin_after_ticks
                                 if engine == "tick"
                                 else self.clock + rejoin_after_ticks
                                 * tick_s)
            if (crashed and rejoin_at is not None
                    and self.servers[crash_server_id].state == "down"
                    and ((t - 1 == rejoin_at) if engine == "tick"
                         else self.clock >= rejoin_at - 1e-9)):
                self.rejoin_server(crash_server_id)
            if nxt is None and self.pending == 0 and not chaos_left:
                break
            if self.stalled(arrivals_left=(nxt is not None
                                           or bool(chaos_left))):
                break
        self.finalize_metrics()
        return completed

    def finalize_metrics(self) -> None:
        """Fold per-server hot-path and cold-start accounting into the
        metrics store (end of a run; fleets call this per pool)."""
        for s in self.servers:
            self.metrics.record_hotpath(s.srv.hotpath_stats())
            self.metrics.record_coldstart(self._metrics_sid(s.sid),
                                          s.cold_start_record())
        if self.multicast is not None:
            self.metrics.on_multicast(self.multicast.stats())
        if self.state_tier is not None:
            # replace-semantics: the tier's counters are fleet-global, so
            # per-pool finalize calls all observe the same totals
            self.metrics.on_state_tier(self.state_tier.stats())
