"""Cluster metrics: TTFT/TBT percentiles, queue depth, GPU-seconds.

One ``ClusterMetrics`` instance per router run accumulates per-request
records and per-tick gauges, then summarizes to a flat dict / JSON blob so
``benchmarks/`` can track the trajectory across PRs.  Times are in router
clock seconds (logical ticks × tick_s on CPU; wall seconds on real slices).
Records carry the request's absolute TTFT deadline, so ``summary`` also
reports SLO attainment and ``ttft_curve`` the percentile curves the
full-day Azure replay benchmark appends to ``BENCH_fleet.json``.

See ``docs/ARCHITECTURE.md`` § "Cluster: metrics" and
``docs/BENCHMARKS.md`` for the recorded schema.

The port's own copy of ``repro/cluster/metrics.py``
(plain Python and numpy: the port imports nothing of the JAX package).
"""
from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Tuple


def percentile(xs: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0,100]); 0.0 on empty input.

    Nearest rank is the smallest 1-based rank k with k/n >= q/100, i.e.
    ``k = ceil(q/100 * n)`` — NOT a rounded interpolation over the index
    range (``round(q/100 * (n-1))`` biases high percentiles downward,
    e.g. it reports p50 of 100 samples as the 51st value).
    """
    if not xs:
        return 0.0
    s = sorted(xs)
    k = min(len(s) - 1, max(0, math.ceil(q / 100.0 * len(s)) - 1))
    return s[k]


def _gauge_max(samples: List[Tuple[float, int]]) -> float:
    """Max of a per-tick gauge.  In a fleet, every pool appends its own
    sample at the shared tick timestamp — same-time samples sum first, so
    the max is fleet-wide, not per-pool."""
    agg: Dict[float, int] = {}
    for t, v in samples:
        agg[t] = agg.get(t, 0) + v
    return float(max(agg.values(), default=0))


@dataclass(slots=True)
class RequestRecord:
    """Per-request latency record.  ``slots=True`` matters: a full-day
    Azure replay holds ~10⁶ of these, and slots halve the footprint."""
    rid: int
    arrival: float
    first_token: Optional[float] = None
    finished: Optional[float] = None
    n_tokens: int = 0
    reroutes: int = 0            # times the request moved servers (crashes)
    # server that completed it: sid, or "pool/sid" in a multi-model fleet
    server: object = -1
    model: Optional[str] = None  # fleet pool that served it (multi-model)
    deadline: Optional[float] = None  # absolute TTFT deadline (SLO)

    @property
    def ttft(self) -> Optional[float]:
        return None if self.first_token is None \
            else self.first_token - self.arrival

    @property
    def tbt(self) -> Optional[float]:
        """Mean time-between-tokens after the first."""
        if self.finished is None or self.first_token is None \
                or self.n_tokens < 2:
            return None
        return (self.finished - self.first_token) / (self.n_tokens - 1)


@dataclass
class ClusterMetrics:
    """Shared metrics store: per-request records, per-tick gauges, event
    log, and the recovery/cold-start/hot-path accounting a run folds in —
    summarized to a flat dict (``summary``) or JSON (``to_json``)."""
    records: Dict[int, RequestRecord] = field(default_factory=dict)
    queue_depth: List[Tuple[float, int]] = field(default_factory=list)
    n_servers: List[Tuple[float, int]] = field(default_factory=list)
    gpu_seconds: float = 0.0
    # device-seconds of capacity lost to partially-crashed servers that
    # kept serving (repartition mode): sum over ticks of
    # (dead devices on live servers) * tick duration
    degraded_seconds: float = 0.0
    events: List[Tuple[float, str, str]] = field(default_factory=list)
    hotpath: Dict[str, float] = field(default_factory=dict)
    # crash-recovery accounting: how each displaced in-flight request was
    # resumed ("migrate" = KV snapshot imported on a survivor, "reprefill" =
    # prompt+prefix recomputed, "reconstruct" = partial-crash in-place
    # rebuild) and how many prompt/prefix tokens each path saved or re-spent
    recovery: Dict[str, float] = field(default_factory=dict)
    # overlapped cold-start accounting, one record per server (latest
    # generation wins on rejoin): time_to_ready / time_to_fully_loaded on
    # the router clock, wall-clock equivalents + loaded bytes from the
    # engine's per-round fill accounting (see ClusterServer.cold_start_record)
    # — keyed by sid, or "pool/sid" strings in a multi-model fleet
    coldstart: Dict = field(default_factory=dict)
    # peer-to-peer multicast scale-out accounting (cluster/multicast.py):
    # bytes/segments by source kind plus the fault-handling counters
    # (re-roots, retries, host fallbacks, receiver stall time)
    multicast: Dict[str, float] = field(default_factory=dict)
    # fleet state-tier accounting (cluster/state_tier.py): warm-state
    # spill/resurrect counters from the run's shared StateTier
    state_tier: Dict[str, float] = field(default_factory=dict)
    # the time source this run records against (the router injects its
    # Clock here, so external instrumentation can stamp events with
    # ``metrics.now()`` under logical AND wall time without branching)
    clock: Optional[object] = field(default=None, repr=False, compare=False)

    def now(self) -> float:
        """The run's current time off the injected clock (0.0 unwired)."""
        return self.clock.now() if self.clock is not None else 0.0

    # ---- recording --------------------------------------------------------
    def on_submit(self, rid: int, arrival: float,
                  model: Optional[str] = None,
                  deadline: Optional[float] = None) -> None:
        """Open a request's record at its arrival time (``deadline`` is
        the absolute TTFT SLO instant, if the trace carries one)."""
        self.records[rid] = RequestRecord(rid, arrival, model=model,
                                          deadline=deadline)

    def on_first_token(self, rid: int, t: float) -> None:
        """Stamp the first-token instant (idempotent: reroutes and
        re-prefills after a crash must not move an already-set TTFT)."""
        r = self.records[rid]
        if r.first_token is None:
            r.first_token = t

    def on_finish(self, rid: int, t: float, n_tokens: int,
                  server) -> None:
        """Close a request's record: finish time, length, serving server."""
        r = self.records[rid]
        r.finished = t
        r.n_tokens = n_tokens
        r.server = server

    def on_reroute(self, rid: int) -> None:
        """Count one cross-server move (crash re-dispatch) for ``rid``."""
        self.records[rid].reroutes += 1

    def on_tick(self, t: float, queue_depth: int, n_servers: int,
                gpu_busy: int, tick_s: float) -> None:
        """One dense-tick gauge sample; accrues ``gpu_busy * tick_s``
        GPU-seconds (the event engine settles quiescent gaps separately —
        see ``ClusterRouter._settle_gap``)."""
        self.queue_depth.append((t, queue_depth))
        self.n_servers.append((t, n_servers))
        self.gpu_seconds += gpu_busy * tick_s

    def on_event(self, t: float, kind: str, detail: str = "") -> None:
        """Append to the free-form event log (spawns, crashes, retires,
        unservable requests, ...)."""
        self.events.append((t, kind, detail))

    def on_recovery(self, mode: str, rid: int, n_tokens: int) -> None:
        """One in-flight request resumed after a crash via ``mode``.

        ``n_tokens``: for "migrate", the prompt+prefix tokens whose state
        moved instead of being recomputed; for "reprefill", the tokens that
        had to be re-prefilled on the survivor; for "repartition", the
        tokens whose state stayed in place across the stage re-split
        (none re-prefilled, none moved off-server).
        """
        assert mode in ("migrate", "reprefill", "repartition"), mode
        self.recovery[f"mode_{mode}"] = \
            self.recovery.get(f"mode_{mode}", 0.0) + 1.0
        key = {"migrate": "migrated_tokens",
               "reprefill": "reprefill_tokens",
               "repartition": "repartition_tokens"}[mode]
        self.recovery[key] = self.recovery.get(key, 0.0) + float(n_tokens)

    def on_reconstruct(self, stats: Dict[str, float]) -> None:
        """Accumulate one partial-crash ``reconstruct_cache`` stats dict
        (per-layer work counts: kv_reused / full_prefill / window_recompute
        / layers_skipped / layers_recomputed + token counts); the
        reconstructed requests count toward ``mode_reconstruct``."""
        for k, v in stats.items():
            if k == "reconstructed_reqs":
                continue              # surfaced as mode_reconstruct below
            key = f"reconstruct_{k}"
            self.recovery[key] = self.recovery.get(key, 0.0) + float(v)
        self.recovery["mode_reconstruct"] = \
            self.recovery.get("mode_reconstruct", 0.0) \
            + float(stats.get("reconstructed_reqs", 0.0))

    def on_relay(self, stats: Dict[str, float]) -> None:
        """Accumulate one repartition ``relay_inflight`` stats dict (same
        per-layer work counts as reconstruction, landed in one scatter);
        requests themselves count toward ``mode_repartition`` via
        ``on_recovery`` — this records only the re-lay work."""
        for k, v in stats.items():
            if k == "relayed_reqs":
                continue              # surfaced as mode_repartition counts
            key = f"relay_{k}"
            self.recovery[key] = self.recovery.get(key, 0.0) + float(v)

    def on_multicast(self, stats: Dict[str, float]) -> None:
        """Fold one ``MulticastManager.stats()`` dict into the store
        (sum-accumulates, so multi-pool fleets can fold one manager per
        pool): peer vs host traffic split, re-roots after source crashes,
        retry/backoff attempts, graceful host fallbacks, stall time."""
        for k, v in stats.items():
            self.multicast[k] = self.multicast.get(k, 0.0) + float(v)

    def record_hotpath(self, stats: Dict[str, float]) -> None:
        """Accumulate one server's decode hot-path stats (see
        ``serving.engine.ContinuousBatcher.hotpath_stats``): counters sum
        across servers; compile counts sum too (each server jits its own
        functions), so per-server regressions stay visible in the total."""
        for k in ("n_decode_steps", "decode_time_s", "n_prefill_calls",
                  "n_prefill_reqs", "n_prefill_pipeline", "n_prefill_tokens",
                  "n_batched_imports", "n_relay_scatters",
                  "prefix_hits", "prefix_hit_tokens", "prefix_evictions",
                  "decode_compiles", "prefill_compiles"):
            self.hotpath[k] = self.hotpath.get(k, 0.0) + stats.get(k, 0.0)

    def on_state_tier(self, stats: Dict[str, float]) -> None:
        """Record the run's ``StateTier.stats()`` snapshot.  REPLACE
        semantics (not sum): the tier's counters are already lifetime
        totals for the shared instance, and the router re-folds them at
        ``finalize_metrics`` — summing would double-count every call."""
        self.state_tier = {k: float(v) for k, v in stats.items()}

    def record_coldstart(self, sid, rec: Dict) -> None:
        """Record one server's cold-start accounting (latest wins).
        ``sid`` is an int for a standalone router, "pool/sid" in a fleet."""
        self.coldstart[sid] = rec

    # ---- summary ----------------------------------------------------------
    def ttft_curve(self, qs: Tuple[float, ...] = (50, 90, 95, 99, 99.9)
                   ) -> Dict[str, float]:
        """TTFT percentile curve over completed requests — the shape the
        full-day replay benchmark records (one sort, many quantiles)."""
        ttfts = sorted(r.ttft for r in self.records.values()
                       if r.finished is not None and r.ttft is not None)
        out: Dict[str, float] = {}
        for q in qs:
            if not ttfts:
                out[f"ttft_p{q:g}"] = 0.0
                continue
            k = min(len(ttfts) - 1,
                    max(0, math.ceil(q / 100.0 * len(ttfts)) - 1))
            out[f"ttft_p{q:g}"] = ttfts[k]
        return out

    def slo_stats(self) -> Tuple[float, float]:
        """(attainment, n) over deadline-carrying requests: the fraction
        whose first token beat its absolute TTFT deadline.  A request that
        never produced a first token counts as a miss; requests without
        deadlines are excluded entirely."""
        with_slo = [r for r in self.records.values()
                    if r.deadline is not None]
        if not with_slo:
            return 0.0, 0.0
        hit = sum(1 for r in with_slo
                  if r.first_token is not None
                  and r.first_token <= r.deadline + 1e-9)
        return hit / len(with_slo), float(len(with_slo))

    def summary(self) -> Dict[str, float]:
        """Flatten the run to stable scalar keys: request counts, TTFT /
        TBT percentiles, SLO attainment, gauge maxima, GPU-seconds,
        throughput, plus always-present recovery and cold-start keys (so
        trajectory diffs line up across runs with and without crashes)."""
        done = [r for r in self.records.values() if r.finished is not None]
        ttfts = [r.ttft for r in done if r.ttft is not None]
        tbts = [r.tbt for r in done if r.tbt is not None]
        horizon = max((r.finished for r in done), default=0.0)
        slo_att, slo_n = self.slo_stats()
        out = {
            "n_requests": float(len(self.records)),
            "n_completed": float(len(done)),
            "n_rerouted": float(sum(1 for r in done if r.reroutes)),
            "ttft_mean": sum(ttfts) / len(ttfts) if ttfts else 0.0,
            "ttft_p50": percentile(ttfts, 50),
            "ttft_p90": percentile(ttfts, 90),
            "ttft_p99": percentile(ttfts, 99),
            "slo_attainment": slo_att,
            "slo_n": slo_n,
            "tbt_mean": sum(tbts) / len(tbts) if tbts else 0.0,
            "tbt_p50": percentile(tbts, 50),
            "tbt_p99": percentile(tbts, 99),
            "queue_depth_max": _gauge_max(self.queue_depth),
            "servers_max": _gauge_max(self.n_servers),
            "gpu_seconds": self.gpu_seconds,
            "degraded_seconds": self.degraded_seconds,
            "tokens_total": float(sum(r.n_tokens for r in done)),
            "throughput_tok_s": (sum(r.n_tokens for r in done) / horizon
                                 if horizon > 0 else 0.0),
        }
        for k, v in self.hotpath.items():
            out[f"hotpath_{k}"] = v
        # always-present recovery counters (zero when no crash happened) so
        # trajectory diffs and the bench JSON have stable keys
        rec = {"mode_migrate": 0.0, "mode_reprefill": 0.0,
               "mode_reconstruct": 0.0, "mode_repartition": 0.0,
               "migrated_tokens": 0.0, "reprefill_tokens": 0.0,
               "repartition_tokens": 0.0}
        rec.update(self.recovery)
        for k, v in rec.items():
            out[f"recovery_{k}"] = v
        # always-present multicast counters (zeros when multicast is off)
        mc = {"peer_bytes": 0.0, "host_bytes": 0.0, "peer_segments": 0.0,
              "host_segments": 0.0, "reroots": 0.0, "retries": 0.0,
              "host_fallbacks": 0.0, "stalled_seconds": 0.0}
        mc.update(self.multicast)
        for k, v in mc.items():
            out[f"multicast_{k}"] = v
        # always-present state-tier / prefix-cache counters (zeros when the
        # prefix cache is off) — the five keys the bench schema pins
        out["prefix_hits"] = self.hotpath.get("prefix_hits", 0.0)
        out["prefix_hit_tokens"] = self.hotpath.get("prefix_hit_tokens", 0.0)
        out["prefix_evictions"] = self.hotpath.get("prefix_evictions", 0.0)
        out["spill_resurrections"] = \
            self.state_tier.get("spill_resurrections", 0.0)
        out["spilled_bytes"] = self.state_tier.get("spilled_bytes", 0.0)
        if self.hotpath.get("decode_time_s", 0.0) > 0:
            out["hotpath_decode_steps_per_s"] = \
                self.hotpath["n_decode_steps"] / self.hotpath["decode_time_s"]
        # cold-start summary (always-present keys; zeros when no server
        # reported) — scale-up latency as the fleet experienced it
        ttrs = [r["time_to_ready"] for r in self.coldstart.values()
                if r.get("time_to_ready") is not None]
        ttfs = [r["time_to_fully_loaded"] for r in self.coldstart.values()
                if r.get("time_to_fully_loaded") is not None]
        out["coldstart_n_servers"] = float(len(self.coldstart))
        out["coldstart_time_to_ready_mean"] = \
            sum(ttrs) / len(ttrs) if ttrs else 0.0
        out["coldstart_time_to_ready_max"] = max(ttrs, default=0.0)
        out["coldstart_time_to_fully_loaded_mean"] = \
            sum(ttfs) / len(ttfs) if ttfs else 0.0
        out["coldstart_served_while_loading"] = float(sum(
            1 for r in self.coldstart.values()
            if r.get("served_while_loading")))
        out["coldstart_loaded_bytes"] = float(sum(
            r.get("loaded_bytes") or 0 for r in self.coldstart.values()))
        return out

    def summary_by_model(self) -> Dict[str, Dict[str, float]]:
        """Cross-pool view: per-model request-latency summaries (fleet
        runs tag records with their pool; untagged requests group under
        ``"default"``)."""
        groups: Dict[str, List[RequestRecord]] = {}
        for r in self.records.values():
            groups.setdefault(r.model or "default", []).append(r)
        out: Dict[str, Dict[str, float]] = {}
        for model, recs in sorted(groups.items()):
            done = [r for r in recs if r.finished is not None]
            ttfts = [r.ttft for r in done if r.ttft is not None]
            tbts = [r.tbt for r in done if r.tbt is not None]
            out[model] = {
                "n_requests": float(len(recs)),
                "n_completed": float(len(done)),
                "ttft_mean": sum(ttfts) / len(ttfts) if ttfts else 0.0,
                "ttft_p50": percentile(ttfts, 50),
                "ttft_p99": percentile(ttfts, 99),
                "tbt_p50": percentile(tbts, 50),
                "tbt_p99": percentile(tbts, 99),
                "tokens_total": float(sum(r.n_tokens for r in done)),
            }
        return out

    def to_json(self, path: Optional[str] = None) -> str:
        """Full dump — summary, per-model summaries, every request
        record, gauges, events — as a JSON string (also written to
        ``path`` when given)."""
        doc = {
            "summary": self.summary(),
            "models": self.summary_by_model(),
            "requests": [asdict(r) for r in
                         sorted(self.records.values(), key=lambda r: r.rid)],
            "queue_depth": self.queue_depth,
            "n_servers": self.n_servers,
            "events": self.events,
            "recovery": self.recovery,
            "coldstart": [self.coldstart[sid]
                          for sid in sorted(self.coldstart,
                                            key=lambda k: (str(type(k)),
                                                           k))],
        }
        blob = json.dumps(doc, indent=1)
        if path:
            with open(path, "w") as f:
                f.write(blob)
        return blob
