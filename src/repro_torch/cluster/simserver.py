"""Modeled (JAX-free) cluster server for full-day trace replay.

The real ``ClusterServer`` runs an actual pipelined cold start and a real
continuous-batching decode per tick — exactly right for correctness tests
and small benches, and exactly wrong for replaying the ~10⁶ arrivals in a
full Azure Functions day on CPU.  ``SimServer`` keeps the *scheduling
surface* bit-compatible (state machine, ``load``/``admitting``/
``can_serve``/``predicted_ready_s``/``needs_tick``, a batcher facade with
``active``/``free``, resident adapters, queued requests) while modeling
the data plane:

* cold start: ready after ``SimProfile.ready_ticks`` ticks, fully loaded
  after ``full_ticks`` — the tick-count shape of the pipelined loader;
* decode: one token per active request per tick; admission emits the
  first token and the same tick's decode step emits the next, matching
  ``ServingEngine.step`` (admission prefill + batch decode per call);
* adapter epochs: the active batch shares one adapter (the merged-LoRA
  epoch barrier) — a queued request for a different adapter waits for a
  full drain.  FIFO with head-of-line barrier; a documented
  approximation of the epoch scheduler's budgeted rotation.

Because it plugs into ``ClusterRouter`` via ``server_factory``, every
piece above the server — dispatch policies, autoscaler, event engine,
metrics, traces — is the REAL code under test; only the token generation
is synthetic.  ``benchmarks/run.py``'s ``azure_day`` bench replays a
million-arrival day this way in seconds.

See ``docs/ARCHITECTURE.md`` § "Cluster: the modeled backend".

The port's own copy of ``repro/cluster/simserver.py``
(plain Python and numpy: the port imports nothing of the JAX package).
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.engine import ServeRequest


@dataclass
class SimProfile:
    """Tick-count shape of the modeled server's cold start.

    ``ready_ticks``/``full_ticks`` drive the default host fill; under
    multicast scale-out the fill is bandwidth-priced instead, as
    ``n_segments`` equal shares of ``bytes_total`` delivered by the
    ``MulticastManager`` (ready once the same ready/full *fraction* of
    segments has landed)."""
    ready_ticks: int = 2        # spawn -> admitting (1/N of the model in)
    full_ticks: int = 10        # spawn -> fully loaded (background fill)
    bytes_total: int = 1 << 30  # pretend checkpoint size (accounting only)
    n_segments: int = 8         # multicast granularity (segments per copy)
    # modeled KV footprint per cached prompt token: prices rows-less
    # PrefixCache entries (and thus state-tier spill bundles) in bytes
    kv_bytes_per_token: int = 1 << 12


class _SimBatcher:
    """Slot accounting shaped like ``serving.engine.ContinuousBatcher``:
    policies read ``.active`` (rid -> request) and ``.free`` (open slot
    ids) to price slot waits and epoch drains."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.active: Dict[int, ServeRequest] = {}
        self.free: List[int] = list(range(n_slots - 1, -1, -1))


class _SimServing:
    """``ServingEngine`` facade over modeled decode (the ``srv`` the
    scheduling policies introspect)."""

    def __init__(self, n_slots: int, adapter_params: Dict[str, Any]):
        self.adapter_params = adapter_params
        self.batcher = _SimBatcher(n_slots)
        self.pending: deque = deque()
        self.clock = 0.0
        self.epoch_adapter: Optional[str] = None
        self.n_steps = 0
        # modeled prefix-cache mirror (rows-less entries): token VALUES are
        # unchanged on a hit — only the hit/byte accounting moves, so the
        # tick==event stream-parity invariant is untouched
        self._pc = None
        self._pc_tag = "sim"
        self._pc_bytes_per_token = 1 << 12
        self._pc_evict_base = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.n_prefill_tokens = 0

    # ---- scheduling surface (mirrors ServingEngine) -----------------------
    @property
    def n_pending(self) -> int:
        return len(self.pending) + len(self.batcher.active)

    def queued_requests(self) -> List[ServeRequest]:
        return list(self.pending)

    def resident_adapters(self) -> set:
        if self.batcher.active:
            return {self.epoch_adapter}
        return set(self.adapter_params) | {None}

    def predicted_step_cost_s(self, default: float = 0.05) -> float:
        return default            # modeled: a decode step costs one tick

    def hotpath_stats(self) -> Dict[str, float]:
        evics = 0.0 if self._pc is None \
            else float(self._pc.evictions - self._pc_evict_base)
        return {"n_decode_steps": float(self.n_steps),
                "n_prefill_tokens": float(self.n_prefill_tokens),
                "prefix_hits": float(self.prefix_hits),
                "prefix_hit_tokens": float(self.prefix_hit_tokens),
                "prefix_evictions": evics}

    # ---- data plane (modeled) ---------------------------------------------
    def submit(self, req: ServeRequest) -> None:
        self.pending.append(req)

    def step(self, now: Optional[float] = None) -> List[ServeRequest]:
        """One modeled engine step: admit (first token), then decode one
        token for every active request — the call shape of
        ``ServingEngine.step``."""
        if now is not None:
            self.clock = max(self.clock, now)
        b = self.batcher
        # admission: FIFO under the epoch barrier (active batch shares one
        # adapter); the head blocking on an epoch switch waits for drain
        while self.pending and b.free:
            req = self.pending[0]
            if b.active and req.adapter != self.epoch_adapter:
                break
            self.pending.popleft()
            if not b.active:
                self.epoch_adapter = req.adapter
            req.slot = b.free.pop()
            b.active[req.rid] = req
            # prefix-cache probe (accounting only: the modeled token stream
            # never depends on cache state, mirroring the real engine's
            # bit-identical-to-cold-prefill guarantee)
            k = 0
            if self._pc is not None and not req.generated:
                hit = self._pc.probe(self._pc_tag, req.adapter,
                                     np.asarray(req.tokens, np.int64))
                if hit is not None:
                    entry, k = hit
                    self.prefix_hits += 1
                    self.prefix_hit_tokens += k
                    self._pc.release(entry)
            self.n_prefill_tokens += max(0, len(req.tokens) - k)
            if req.first_token_at is None:
                req.first_token_at = self.clock
            req.generated.append((req.rid + len(req.generated)) % 250)
        # decode: every active request (including just-admitted — same as
        # the real engine, where admission prefill precedes the batch step)
        done: List[ServeRequest] = []
        for rid in list(b.active):
            req = b.active[rid]
            req.generated.append((req.rid + len(req.generated)) % 250)
            if len(req.generated) >= req.max_new_tokens:
                req.finished_at = self.clock
                req.done = True
                b.free.append(req.slot)
                del b.active[rid]
                done.append(req)
                # deposit the finished prompt's prefix (rows-less entry,
                # priced at kv_bytes_per_token) — same >=2-token floor as
                # the real engine's _deposit_prefixes
                if self._pc is not None and len(req.tokens) >= 2:
                    toks = np.asarray(req.tokens, np.int64)
                    self._pc.insert(
                        self._pc_tag, req.adapter, toks, len(req.tokens),
                        rows=None,
                        nbytes=len(req.tokens) * self._pc_bytes_per_token)
        self.n_steps += 1
        return done

    def drain_inflight(self, export_state: bool = False
                       ) -> List[ServeRequest]:
        out = list(self.batcher.active.values()) + list(self.pending)
        for r in out:
            r.snapshot = None     # modeled backend has no KV to export
            r.slot = None
        self.batcher = _SimBatcher(self.batcher.n_slots)
        self.pending.clear()
        self.epoch_adapter = None
        return out


class SimServer:
    """Drop-in ``ClusterServer`` replacement with a modeled data plane.

    Pass ``sim_server_factory(profile)`` as ``ClusterRouter``'s
    ``server_factory`` — the router, autoscaler, and dispatch policies
    cannot tell the difference (same lifecycle states, same scheduling
    surface), but a tick costs ~microseconds instead of a JAX dispatch.
    """

    def __init__(self, sid: int, cfg, params, ccfg,
                 adapter_params: Optional[Dict[str, Any]] = None,
                 profile: Optional[SimProfile] = None):
        self.sid = sid
        self.cfg = cfg
        self.ccfg = ccfg
        self.profile = profile or SimProfile()
        self.srv = _SimServing(ccfg.n_slots, dict(adapter_params or {}))
        self.state = "loading"
        self.idle_ticks = 0
        self.idle_since: Optional[float] = None
        self.served_while_loading = False
        self.spawned_at = 0.0
        self.ready_at: Optional[float] = None
        self.fully_loaded_at: Optional[float] = None
        self._recover_left = 0
        self._load_ticks = 0
        self.last_recovery: Dict[str, float] = {}
        self.engine = self            # router reads s.engine.loaded_bytes()
        # multicast scale-out: when the router attaches a manager, fill
        # progress is delivered segments instead of counted load ticks
        self._mc = None
        self._segs_done = 0
        # state-tier resurrect: modeled pull cost in whole ticks, gating
        # the loading -> serving flip alongside the normal ready condition
        self.resurrect_cost_s = 0.0
        self._resurrect_ticks_left = 0

    # ---- state-tier surface (mirrors ClusterServer) -----------------------
    def attach_prefix_cache(self, cache) -> None:
        """Wire a (rows-less) ``PrefixCache`` into the modeled engine's
        admission accounting; eviction deltas rebase so a store moving
        between servers never double-counts."""
        self.srv._pc = cache
        self.srv._pc_tag = getattr(self.cfg, "name", None) or "sim"
        self.srv._pc_bytes_per_token = self.profile.kv_bytes_per_token
        self.srv._pc_evict_base = 0 if cache is None else cache.evictions

    def predicted_prefix_tokens(self, req: ServeRequest) -> int:
        """Cached-prefix tokens a dispatch of ``req`` here would reuse
        (pure read — ``SloAware.prefix_bonus_s_per_token`` pricing)."""
        pc = self.srv._pc
        if pc is None:
            return 0
        return pc.match_len(self.srv._pc_tag, req.adapter,
                            np.asarray(req.tokens, np.int64))

    def spill_state(self) -> Optional[Dict[str, Any]]:
        """Bundle this server's warm state for the ``StateTier`` (None
        when there is nothing worth spilling)."""
        pc = self.srv._pc
        if pc is None:
            return None
        entries = pc.export_entries()
        if not entries:
            return None
        return {"prefix_entries": entries,
                "adapters": dict(self.srv.adapter_params),
                "nbytes": int(sum(e.nbytes for _, e in entries))}

    def resurrect_from(self, bundle: Dict[str, Any],
                       cost_s: float = 0.0) -> int:
        """Seed this spawn from a spilled bundle; the modeled pull holds
        the server in ``loading`` for ``ceil(cost_s / tick_s)`` extra
        ticks (max-overlapped with the normal cold start, like the real
        lane's ``predicted_ready_s`` bound).  Returns entries admitted."""
        pc = self.srv._pc
        n = 0
        if pc is not None:
            n = pc.import_entries(bundle.get("prefix_entries", ()))
        for name, params in bundle.get("adapters", {}).items():
            self.srv.adapter_params.setdefault(name, params)
        self.resurrect_cost_s = max(self.resurrect_cost_s, float(cost_s))
        self._resurrect_ticks_left = max(
            self._resurrect_ticks_left,
            int(math.ceil(cost_s / max(self.ccfg.tick_s, 1e-9))))
        return n

    # ---- multicast surface (mirrors ClusterServer) ------------------------
    @property
    def _ready_segs(self) -> int:
        """Segments needed before admitting: the same ready fraction the
        tick-counted cold start uses (``ready_ticks/full_ticks``)."""
        p = self.profile
        return max(1, math.ceil(p.n_segments * p.ready_ticks
                                / max(1, p.full_ticks)))

    def mc_seg_bytes(self) -> List[int]:
        """Per-segment byte sizes of one model copy (equal shares of
        ``bytes_total``, remainder on the last segment)."""
        p = self.profile
        share = p.bytes_total // p.n_segments
        out = [share] * p.n_segments
        out[-1] += p.bytes_total - share * p.n_segments
        return out

    def mc_attach(self, manager) -> None:
        """Switch this server's fill to multicast deliveries."""
        self._mc = manager
        self._segs_done = 0

    def mc_deliver(self, segments: Sequence[int]) -> None:
        """Accept segments the manager finished streaming this tick."""
        self._segs_done += len(segments)

    @property
    def mc_active_sends(self) -> int:
        """Outbound multicast transfers this server is sourcing (0 when
        multicast is off) — priced by ``SloAware.source_penalty_s``."""
        return 0 if self._mc is None else self._mc.active_sends(self.sid)

    # ---- engine facade ----------------------------------------------------
    @property
    def fully_loaded(self) -> bool:
        if self._mc is not None:
            return self._segs_done >= self.profile.n_segments
        return self._load_ticks >= self.profile.full_ticks

    def loaded_bytes(self) -> int:
        """Modeled fill progress in bytes (delivered segments under
        multicast, linear in load ticks otherwise)."""
        if self._mc is not None:
            frac = min(1.0, self._segs_done / max(1, self.profile.n_segments))
        else:
            frac = min(1.0, self._load_ticks / max(1, self.profile.full_ticks))
        return int(self.profile.bytes_total * frac)

    def cold_start_stats(self) -> Dict[str, Any]:
        """Engine-facade stats (no wall-clock accounting: modeled)."""
        n_rounds = (self._segs_done if self._mc is not None
                    else self._load_ticks)
        return {"time_to_ready": None, "time_to_fully_loaded": None,
                "loaded_bytes": self.loaded_bytes(),
                "total_bytes": self.profile.bytes_total,
                "n_rounds": n_rounds}

    # ---- scheduling surface -----------------------------------------------
    @property
    def admitting(self) -> bool:
        return self.state == "serving"

    @property
    def degraded_devices(self) -> int:
        """Dead-device count while serving (surface parity with
        ``ClusterServer``).  Modeled servers have no device list, so a
        SimServer is never partially degraded: 0."""
        return 0

    @property
    def load(self) -> int:
        return self.srv.n_pending

    @property
    def needs_tick(self) -> bool:
        if self.state in ("down", "retired"):
            return False
        if self.state in ("loading", "recovering"):
            return True
        return bool(self.srv.n_pending) or not self.fully_loaded

    def can_serve(self, req: ServeRequest) -> bool:
        """Whether this server preloaded the request's adapter."""
        return req.adapter is None or req.adapter in self.srv.adapter_params

    def predicted_ready_s(self, now: float) -> float:
        """Seconds until admitting: remaining load/recovery ticks at
        nominal ``tick_s`` (0 serving, +inf down/retired)."""
        if self.state == "serving":
            return 0.0
        if self.state == "loading":
            if self._mc is not None:
                base = self._mc.eta_s(self.sid,
                                      self._ready_segs - self._segs_done)
            else:
                left = max(0, self.profile.ready_ticks - self._load_ticks)
                base = left * self.ccfg.tick_s
            # a state-tier pull overlaps the cold start; readiness is the
            # slower of the two (mirrors ClusterServer.predicted_ready_s)
            return max(base, self._resurrect_ticks_left * self.ccfg.tick_s)
        if self.state == "recovering":
            return max(0, self._recover_left) * self.ccfg.tick_s
        return math.inf

    @property
    def oldest_queued_arrival(self) -> Optional[float]:
        waiting = [r.arrival for r in self.srv.pending
                   if r.first_token_at is None]
        return min(waiting) if waiting else None

    def submit(self, req: ServeRequest) -> None:
        """Queue a dispatched request on the modeled serving engine."""
        self.srv.submit(req)

    # ---- lifecycle (mirrors ClusterServer.tick) ---------------------------
    def tick(self, now: float) -> List[ServeRequest]:
        """One lifecycle tick, mirroring ``ClusterServer.tick``: load
        progress (ready flip serves the SAME tick), recovery countdown,
        background fill, one modeled engine step, idle bookkeeping."""
        if self.state == "loading":
            if self._resurrect_ticks_left > 0:
                self._resurrect_ticks_left -= 1   # state-tier pull in flight
            if self._mc is None:
                self._load_ticks += 1
                if self._load_ticks < self.profile.ready_ticks:
                    return []
            elif self._segs_done < self._ready_segs:
                return []       # multicast fill: waiting on deliveries
            if self._resurrect_ticks_left > 0:
                return []       # warm pull outlives the cold start: wait
            self.state = "serving"
            if self.ready_at is None:
                self.ready_at = now
        if self.state == "recovering":
            self._recover_left -= 1
            if self._recover_left <= 0:
                self.state = "serving"
            return []
        if self.state in ("down", "retired"):
            return []
        if not self.fully_loaded:
            if self._mc is None:
                self._load_ticks += 1   # background fill (host ticks)
            if self.srv.n_pending:
                self.served_while_loading = True
        if self.fully_loaded and self.fully_loaded_at is None:
            self.fully_loaded_at = now
        done = self.srv.step(now=now)
        if self.srv.n_pending:
            self.idle_ticks = 0
            self.idle_since = None
        else:
            self.idle_ticks += 1
            if self.idle_since is None:
                self.idle_since = now
        return done

    def cold_start_record(self) -> Dict[str, Any]:
        """Cold-start accounting in ``ClusterServer.cold_start_record``'s
        exact shape (wall fields None: modeled)."""
        eng = self.cold_start_stats()
        rdy, ful = self.ready_at, self.fully_loaded_at
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
        """Whole-server crash only (the modeled backend has no per-device
        KV state to partially lose): drains everything for re-dispatch."""
        self.last_recovery = {}
        drained = self.srv.drain_inflight()
        self.state = "down"
        return drained

    def rejoin(self) -> None:
        """Reboot after a crash: full cold start from zero load ticks
        (and zero delivered segments under multicast)."""
        self.state = "loading"
        self._load_ticks = 0
        self._segs_done = 0
        self._resurrect_ticks_left = 0
        self.ready_at = None
        self.fully_loaded_at = None
        self.served_while_loading = False

    def retire(self) -> List[ServeRequest]:
        """Voluntary scale-down; leftovers re-queue through dispatch."""
        leftovers = self.srv.drain_inflight()
        self.state = "retired"
        return leftovers


def sim_server_factory(profile: Optional[SimProfile] = None):
    """A ``server_factory`` for ``ClusterRouter``: every spawned server is
    a ``SimServer`` with the given cold-start profile."""
    def factory(sid, cfg, params, ccfg, adapter_params=None):
        return SimServer(sid, cfg, params, ccfg, adapter_params,
                         profile=profile)
    return factory
