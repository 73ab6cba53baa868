"""Peer-to-peer multicast scale-out: warm servers as load sources.

Scale-up used to pull every new server's model copy from host DRAM at
``host_link_bw`` — N simultaneous cold starts read the checkpoint N times
and contend for ``host_agg_bw``.  This module implements the λScale /
HydraServe direction (ROADMAP open item 1): spawning servers pull layer
*segments* from warm or partially-warm peers over ``ici_bw`` instead, and
every receiver relays segments it already holds onward — a chain
(``fanout=1``) or binary tree (``fanout=2``) propagation in which N
simultaneous cold starts cost ~one host read of aggregate host traffic.

The transfer economics come from the ``HwModel`` cost model in
``core/simulator.py`` (the same one ``snapshot_transfer_time`` prices
migrations with): peer links move bytes at ``hw.ici_bw`` plus one
``hw.hop_latency`` per segment; host pulls move at
``host_bw_effective(hw, concurrent)`` so simultaneous host streams share
the aggregate read path.  ``MulticastManager.advance(now, dt)`` moves the
fluid model forward one router tick; completed segments are handed to
their receivers *before* the servers tick, so the overlapped-fill
machinery (same-tick ready flips, serving mid-fill) works unchanged on
top.

Fault tolerance — the robustness core:

* **source crash**: every transfer sourced from the victim aborts;
  receivers keep all fully-received segments (resume, never restart from
  zero) and re-root onto a surviving holder the next tick.
* **orphaned segment**: if a segment some peer once held has no live
  holder, the receiver retries with exponential backoff
  (``retry_backoff_s * 2^(n-1)``) up to ``max_retries`` times — a peer
  mid-pull may complete it — then degrades gracefully to a host fill
  (counted as ``host_fallbacks``).
* **receiver crash**: its inbound transfer dies with it; its children
  re-root like any source loss.  On rejoin the router re-registers it as
  a fresh receiver.

Everything here is deterministic pure-Python bookkeeping (no JAX, no wall
clock, no RNG): receivers are processed in sid order and transfers move
by per-tick byte budgets, so the tick and event cluster engines — which
both tick densely while any server is loading — execute the same
schedule bit-for-bit.

See ``docs/ARCHITECTURE.md`` § "Cluster: multicast scale-out".

The port's own copy of ``repro/cluster/multicast.py``
(plain Python and numpy: the port imports nothing of the JAX package).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

from repro_torch.core.simulator import (GPU_PAPER, HwModel, host_bw_effective,
                                        snapshot_transfer_time)

# multicast propagation shapes: "chain" relays through one child per
# source, "tree" through two, "host" disables peer serving entirely (every
# receiver pulls from host under the shared-aggregate cost model — the
# honest contended baseline bench_multicast compares against)
TOPOLOGIES = ("chain", "tree", "host")


@dataclass(frozen=True)
class MulticastConfig:
    """Shape and fault-handling knobs of one fleet's multicast scale-out.

    ``fanout`` is the max concurrent outbound transfers per source; None
    derives it from the topology (chain=1, tree=2, host=0).
    ``max_retries``/``retry_backoff_s`` bound the search for a surviving
    holder of an orphaned segment before degrading to host fill.
    """
    topology: str = "tree"
    hw: HwModel = GPU_PAPER
    fanout: Optional[int] = None
    max_retries: int = 3
    retry_backoff_s: float = 0.1

    def __post_init__(self):
        if self.topology not in TOPOLOGIES:
            raise ValueError(f"unknown multicast topology "
                             f"{self.topology!r}; available: {TOPOLOGIES}")

    @property
    def effective_fanout(self) -> int:
        """Outbound transfer slots per source (explicit or per-topology)."""
        if self.fanout is not None:
            return self.fanout
        return {"chain": 1, "tree": 2, "host": 0}[self.topology]


@dataclass
class _Receiver:
    """One spawning server's multicast state: which segments it holds,
    the transfer in flight to it, and its retry ladder for orphaned
    segments.  A completed receiver stays registered — it is the warmest
    possible relay source."""
    sid: int
    seg_bytes: List[int]
    have: Set[int] = field(default_factory=set)
    seg: Optional[int] = None        # segment in flight (None = idle)
    source: Optional[int] = None     # peer sid, or None = host pull
    parent: Optional[int] = None     # current propagation-tree parent:
    # the peer the LAST transfer came from (None = this receiver roots
    # at host); source preference keeps a receiver riding its parent, so
    # the edge persists between transfers and a parent crash re-roots it
    lat_left: float = 0.0            # hop latency still to pay
    bytes_left: float = 0.0          # segment bytes still to move
    retries: int = 0                 # consecutive holderless attempts
    next_try: float = -math.inf      # backoff deadline for the next attempt

    @property
    def done(self) -> bool:
        """True once every segment has been fully received."""
        return len(self.have) >= len(self.seg_bytes)

    def head(self) -> Optional[int]:
        """Next segment to fetch (in-order fill; None when done)."""
        for s in range(len(self.seg_bytes)):
            if s not in self.have:
                return s
        return None

    def abort(self) -> None:
        """Drop the in-flight transfer (source died): completed segments
        are kept — resume from the last fully-received segment."""
        self.seg = None
        self.source = None
        self.lat_left = 0.0
        self.bytes_left = 0.0
        self.next_try = -math.inf


class MulticastManager:
    """Segment-granular multicast scheduler for one router's fleet.

    The router registers every spawned server as a receiver
    (``register_receiver``) and optionally warm non-receiver servers as
    sources (``register_source``); ``advance`` runs once per dense tick
    and returns ``{sid: [segments completed]}`` for the router to deliver
    before the servers tick.  ``remove`` reacts to crashes/retires by
    aborting the victim's transfers and re-rooting its dependents;
    ``stats`` feeds ``ClusterMetrics.on_multicast``.
    """

    def __init__(self, cfg: Optional[MulticastConfig] = None):
        self.cfg = cfg or MulticastConfig()
        self.receivers: Dict[int, _Receiver] = {}
        # warm servers that are sources WITHOUT being receivers
        # (sid -> segments held); receivers relay implicitly via `have`
        self.sources: Dict[int, Set[int]] = {}
        # segments that have ever been fully held by anyone: a missing
        # holder for a seeded segment means a source DIED (retry ladder),
        # an unseeded segment simply has not been bootstrapped yet (pull
        # it from host without burning retries)
        self._seeded: Set[int] = set()
        self._stats: Dict[str, float] = {
            "peer_bytes": 0.0, "host_bytes": 0.0,
            "peer_segments": 0.0, "host_segments": 0.0,
            "reroots": 0.0, "retries": 0.0, "host_fallbacks": 0.0,
            "stalled_seconds": 0.0,
        }

    # ---- membership -------------------------------------------------------
    def register_receiver(self, sid: int,
                          seg_bytes: Sequence[int]) -> None:
        """Enroll a spawning server (fresh or rejoining) as a receiver of
        one full model copy, segment by segment."""
        self.receivers[sid] = _Receiver(sid, [int(b) for b in seg_bytes])

    def register_source(self, sid: int, segments: Sequence[int]) -> None:
        """Enroll (or refresh) a warm non-receiver server as a source
        holding ``segments``; receivers never need this — their ``have``
        set makes them relays automatically."""
        held = set(int(s) for s in segments)
        self.sources[sid] = held
        self._seeded |= held

    def remove(self, sid: int) -> None:
        """A server left the fleet (crash or retire): abort its inbound
        transfer and re-root every dependent — a receiver whose active
        transfer it was sourcing OR whose propagation-tree parent it was.
        Dependents keep all fully-received segments (resume from the last
        complete segment, never restart) and pick a surviving source on
        the next advance; each counts one ``reroots``.  The victim is
        forgotten as a holder."""
        for r in self.receivers.values():
            dependent = ((r.seg is not None and r.source == sid)
                         or r.parent == sid)
            if r.seg is not None and r.source == sid:
                r.abort()
            if dependent and not r.done:
                r.parent = None
                r.next_try = -math.inf
                self._stats["reroots"] += 1.0
        self.sources.pop(sid, None)
        self.receivers.pop(sid, None)

    # ---- introspection ----------------------------------------------------
    @property
    def active(self) -> bool:
        """True while any receiver still has segments to fetch."""
        return any(not r.done for r in self.receivers.values())

    def receiver_done(self, sid: int) -> bool:
        """Has ``sid``'s model copy fully arrived (True for unknowns, so
        non-multicast servers background-fill normally)?"""
        r = self.receivers.get(sid)
        return r is None or r.done

    def active_sends(self, sid: int) -> int:
        """Outbound transfers ``sid`` is currently sourcing (the load the
        SLO-aware dispatch can price via ``source_penalty_s``)."""
        return sum(1 for r in self.receivers.values()
                   if r.seg is not None and r.source == sid)

    def eta_s(self, sid: int, n_segments: Optional[int] = None) -> float:
        """Optimistic seconds until ``sid``'s next ``n_segments`` pending
        segments land (all of them when None): each priced like a peer
        snapshot transfer (``snapshot_transfer_time`` over the nvlink/ICI
        link) — the signal ``predicted_ready_s`` surfaces to dispatch."""
        r = self.receivers.get(sid)
        if r is None:
            return 0.0
        pending = [s for s in range(len(r.seg_bytes)) if s not in r.have]
        if n_segments is not None:
            pending = pending[:max(0, n_segments)]
        return sum(snapshot_transfer_time(r.seg_bytes[s], self.cfg.hw,
                                          link="nvlink") for s in pending)

    def stats(self) -> Dict[str, float]:
        """Session accounting: bytes/segments by source kind, re-roots,
        retries, host fallbacks, receiver stall time."""
        return dict(self._stats)

    # ---- the fluid transfer model -----------------------------------------
    def _holders(self, seg: int, exclude: int) -> List[int]:
        """Live servers (receivers or warm sources) holding ``seg``."""
        out = [sid for sid, r in self.receivers.items()
               if sid != exclude and seg in r.have]
        out += [sid for sid, held in self.sources.items()
                if sid != exclude and seg in held]
        return sorted(set(out))

    def _in_flight(self, seg: int) -> bool:
        """Is some receiver already pulling ``seg`` (it will become a
        holder shortly — waiting beats stampeding to host)?"""
        return any(r.seg == seg for r in self.receivers.values())

    def _held_count(self, sid: int) -> int:
        """How many segments ``sid`` holds (source-preference signal)."""
        r = self.receivers.get(sid)
        if r is not None:
            return len(r.have)
        return len(self.sources.get(sid, ()))

    def _start(self, r: _Receiver, seg: int, source: Optional[int]) -> None:
        """Begin one segment transfer (peer when ``source`` is a sid,
        host when None); hop latency is paid before the first byte."""
        r.seg = seg
        r.source = source
        r.parent = source
        r.lat_left = self.cfg.hw.hop_latency
        r.bytes_left = float(r.seg_bytes[seg])
        r.retries = 0

    def _assign(self, r: _Receiver, t: float) -> bool:
        """Try to start ``r``'s next transfer at time ``t``.  Returns
        True when a transfer started; False when backing off, politely
        waiting on busy holders / an in-flight pull, or done."""
        if r.next_try > t + 1e-12:
            return False                       # backoff not elapsed
        head = r.head()
        if head is None:
            return False                       # done
        if self.cfg.topology == "host":
            self._start(r, head, None)
            return True
        holders = self._holders(head, exclude=r.sid)
        fanout = self.cfg.effective_fanout
        free = [h for h in holders if self.active_sends(h) < fanout]
        if free:
            # least-busy holder first, then the one holding the most
            # segments (a receiver can keep riding it for later segments),
            # then lowest sid for determinism
            src = min(free, key=lambda h: (self.active_sends(h),
                                           -self._held_count(h), h))
            self._start(r, head, src)
            return True
        if holders or self._in_flight(head):
            return False        # holders busy / pull landing soon: wait
        if head not in self._seeded:
            # bootstrap: nobody ever held this segment — someone must
            # read it from host once (this receiver becomes the root)
            self._start(r, head, None)
            return True
        # seeded but orphaned: its holders died.  Retry with backoff (a
        # peer mid-pull may still complete it), then degrade to host.
        r.retries += 1
        if r.retries > self.cfg.max_retries:
            self._stats["host_fallbacks"] += 1.0
            self._start(r, head, None)
            return True
        self._stats["retries"] += 1.0
        r.next_try = t + self.cfg.retry_backoff_s * 2 ** (r.retries - 1)
        return False

    def _bw(self, r: _Receiver) -> float:
        """Current inbound bandwidth for ``r``'s transfer: ICI for peer
        links, contended-aggregate host bandwidth for host pulls."""
        if r.source is not None:
            return self.cfg.hw.ici_bw
        n_host = sum(1 for x in self.receivers.values()
                     if x.seg is not None and x.source is None)
        return host_bw_effective(self.cfg.hw, max(1, n_host))

    def advance(self, now: float, dt: float) -> Dict[int, List[int]]:
        """Move every transfer forward ``dt`` seconds of modeled time;
        returns ``{sid: [segments completed this tick]}``.

        Receivers are processed in sid order and may complete several
        segments per tick (leftover budget rolls into the next transfer,
        including an immediate re-assignment) — so a fast ICI link fills
        many small segments in one tick, exactly like the engine's
        ``segments_per_round`` budget on the host path.  Deterministic:
        no randomness, no wall clock, stable iteration order.
        """
        delivered: Dict[int, List[int]] = {}
        # pre-assign every idle receiver first, so the host-contention
        # pricing below sees the tick's REAL concurrency (assigning lazily
        # inside the progress loop would let the first receiver pull a
        # whole tick at uncontended bandwidth before the others register)
        for sid in sorted(self.receivers):
            r = self.receivers[sid]
            if r.seg is None:
                self._assign(r, now)
        for sid in sorted(self.receivers):
            r = self.receivers[sid]
            left = dt
            while left > 1e-12:
                if r.seg is None:
                    if not self._assign(r, now + (dt - left)):
                        if not r.done:
                            self._stats["stalled_seconds"] += left
                        break
                if r.lat_left > 0.0:
                    pay = min(r.lat_left, left)
                    r.lat_left -= pay
                    left -= pay
                    if left <= 1e-12:
                        break
                bw = self._bw(r)
                need = r.bytes_left / bw
                key = "peer_bytes" if r.source is not None else "host_bytes"
                if need > left + 1e-12:
                    moved = bw * left
                    r.bytes_left -= moved
                    self._stats[key] += moved
                    break
                # segment completes inside this tick
                self._stats[key] += r.bytes_left
                skey = ("peer_segments" if r.source is not None
                        else "host_segments")
                self._stats[skey] += 1.0
                r.have.add(r.seg)
                self._seeded.add(r.seg)
                delivered.setdefault(sid, []).append(r.seg)
                r.seg = None
                r.source = None
                r.bytes_left = 0.0
                left -= need
        return delivered
