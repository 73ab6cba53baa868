"""SLO-driven autoscaler for PipeBoost server fleets (paper §2.1, §4.1).

The point of PipeBoost's fast cold start is that scaling out on a burst is
*cheap*: a fresh multi-GPU server admits traffic after each device loads
only ~1/N of the model.  The autoscaler exploits exactly that — it watches
queue pressure and head-of-line wait (a TTFT SLO proxy) and cold-starts a
new server the moment either degrades, instead of over-provisioning.

Decisions are *time-based*, not call-count-based: spawn cooldown and idle
retirement compare against the injected clock's ``now``, so the same
policy behaves identically under a ``LogicalClock`` tick loop, the
discrete-event engine (which calls ``decide`` at irregular intervals), and
a ``WallClock`` fleet (where "200 ticks idle" used to mean milliseconds of
real time).  The legacy tick thresholds are kept as deriving defaults:
``idle_ticks_before_retire * tick_s`` seconds unless
``idle_seconds_before_retire`` is set explicitly.

Pure policy, no JAX: ``decide`` maps observed cluster state to actions; the
router executes them (spawn => ``ClusterServer`` cold start, retire =>
drain + shutdown of an idle replica).  See ``docs/ARCHITECTURE.md``
§ "Cluster: autoscaling".

The port's own copy of ``repro/cluster/autoscaler.py``
(plain Python and numpy: the port imports nothing of the JAX package).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence


@dataclass
class AutoscalerConfig:
    """Scale-out/retire thresholds (see module docstring for the time
    semantics of the cooldown and idle fields)."""
    target_queue_per_server: float = 4.0   # pending reqs per admitting server
    ttft_slo_s: float = 1.0                # head-of-line wait budget
    max_servers: int = 8
    min_servers: int = 1
    scale_up_cooldown_ticks: int = 5       # between consecutive spawns
    idle_ticks_before_retire: int = 200
    max_warming: int = 1                   # concurrent cold starts
    spawn_batch: int = 1                   # servers per pressured spawn
    # decision (multicast scale-out makes N simultaneous cold starts cost
    # ~one host read, so bursts can spawn in batches; 1 = legacy)
    # time-based overrides; None derives seconds from the tick thresholds
    # above (ticks * tick_s) so existing configs keep their behaviour
    scale_up_cooldown_s: Optional[float] = None
    idle_seconds_before_retire: Optional[float] = None


@dataclass
class ScaleDecision:
    """One round's actions: how many servers to spawn, which to retire."""
    spawn: int = 0
    retire: List[int] = field(default_factory=list)  # server ids to retire


class Autoscaler:
    """Maps observed fleet state to spawn/retire decisions each round;
    stateful only for the spawn cooldown and scale-op counters."""

    def __init__(self, cfg: AutoscalerConfig = None):
        self.cfg = cfg or AutoscalerConfig()
        self._cooldown_until = -1.0
        self.n_scale_ups = 0
        self.n_retires = 0

    def _cooldown_s(self, tick_s: float) -> float:
        if self.cfg.scale_up_cooldown_s is not None:
            return self.cfg.scale_up_cooldown_s
        return self.cfg.scale_up_cooldown_ticks * tick_s

    def _idle_s(self, tick_s: float) -> float:
        if self.cfg.idle_seconds_before_retire is not None:
            return self.cfg.idle_seconds_before_retire
        return self.cfg.idle_ticks_before_retire * tick_s

    def _idle_long_enough(self, s, now: float, tick_s: float) -> bool:
        # time-based when the server tracks idle_since (ClusterServer);
        # tick-count fallback keeps bare test fakes working
        since = getattr(s, "idle_since", None)
        if since is not None:
            return now - since >= self._idle_s(tick_s) - 1e-9
        return s.idle_ticks >= self.cfg.idle_ticks_before_retire

    def decide(self, now: float, pending: int, oldest_wait: float,
               servers: Sequence, tick_s: float = 0.05) -> ScaleDecision:
        """One decision per dispatch round (tick or event).

        ``pending``: router queue + per-server queued/in-flight requests.
        ``oldest_wait``: age of the oldest not-yet-first-token request.
        ``servers``: ClusterServer-likes exposing .state/.admitting/
        .idle_ticks/.sid (and .idle_since for time-based retirement).
        ``tick_s``: nominal tick length, used only to derive seconds from
        legacy tick-count thresholds.
        """
        cfg = self.cfg
        out = ScaleDecision()
        admitting = [s for s in servers if s.admitting]
        warming = [s for s in servers if s.state == "loading"]
        # downed servers count against the cap — they may rejoin, and the
        # cap bounds the provisioned fleet, not just the healthy slice
        live = [s for s in servers if s.state != "retired"]

        per_server = pending / max(1, len(admitting))
        pressured = (per_server > cfg.target_queue_per_server
                     or oldest_wait > cfg.ttft_slo_s)
        if (pressured and now >= self._cooldown_until - 1e-9
                and len(warming) < cfg.max_warming
                and len(live) < cfg.max_servers):
            # batch spawn bounded by both caps (the guard above makes each
            # headroom >= 1, so spawn_batch=1 reproduces legacy decisions)
            out.spawn = max(1, min(cfg.spawn_batch,
                                   cfg.max_warming - len(warming),
                                   cfg.max_servers - len(live)))
            self._cooldown_until = now + self._cooldown_s(tick_s)
            self.n_scale_ups += out.spawn

        if pending == 0:
            for s in admitting:
                if (self._idle_long_enough(s, now, tick_s)
                        and len(live) - len(out.retire) > cfg.min_servers):
                    out.retire.append(s.sid)
                    self.n_retires += 1
        return out

    def next_retire_time(self, servers: Sequence,
                         tick_s: float = 0.05) -> Optional[float]:
        """Earliest future instant an idle server becomes retirable — the
        event engine's "idle deadline" event.  None when no retirement can
        fire (nothing idle, or the min_servers floor would block it)."""
        cfg = self.cfg
        live = [s for s in servers if s.state != "retired"]
        if len(live) <= cfg.min_servers:
            return None
        idle_s = self._idle_s(tick_s)
        times = [s.idle_since + idle_s for s in live
                 if s.admitting and getattr(s, "idle_since", None) is not None]
        return min(times) if times else None
