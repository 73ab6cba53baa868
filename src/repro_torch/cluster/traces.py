"""Bursty arrival traces for the serverless cluster (paper §2.1, Fig. 3).

Serverless LLM workloads are bursty: long quiet stretches punctuated by
request waves that force fleet-wide cold starts (the scenario HydraServe /
λScale benchmark against).  Three generators cover the space:

* ``poisson_trace``    — memoryless baseline (CV = 1).
* ``gamma_trace``      — Gamma-renewal arrivals; ``burstiness`` (= CV²) > 1
                         clusters arrivals into bursts with long gaps.
* ``burst_wave_trace`` — square-wave modulated Poisson: quiet base rate with
                         sudden waves, the canonical scale-out trigger.

Traces are plain ``Arrival`` records, replayable and JSON round-trippable
(``save_trace`` / ``load_trace``) so benchmark runs are reproducible and
real traces (e.g. Azure Functions) can be dropped in the same format.
All generators are deterministic in ``seed``.

Full-day replays *stream*: ``arrival_stream`` feeds the router's event
engine one arrival at a time, and ``iter_azure_trace`` synthesizes an
Azure-shape day minute-by-minute — a million-row trace is never resident
as a list.  See ``docs/ARCHITECTURE.md`` § "Cluster: traces".

The port's own copy of ``repro/cluster/traces.py``
(plain Python and numpy: the port imports nothing of the JAX package).
"""
from __future__ import annotations

import csv
import heapq
import json
from dataclasses import asdict, dataclass, field
from typing import (Dict, Iterable, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np


@dataclass(frozen=True)
class Arrival:
    """One request arrival: when it lands and what it asks for."""
    time: float
    prompt_len: int = 8
    max_new_tokens: int = 6
    adapter: Optional[str] = None
    seed: int = 0               # per-request prompt-content seed
    model: Optional[str] = None          # fleet pool (None = default pool)
    ttft_deadline_s: Optional[float] = None  # TTFT SLO relative to arrival
    # shared-prefix prompts (prefix-cache workloads): the first
    # ``prefix_len`` tokens are drawn from ``prefix_seed`` so arrivals
    # sharing it share an exact token prefix; 0/None = fully per-request
    # content (the pre-state-tier behavior, and what old JSON loads as)
    prefix_len: int = 0
    prefix_seed: Optional[int] = None


def _materialize(times: Sequence[float], rng: np.random.Generator, *,
                 prompt_len: int, max_new_tokens: int,
                 adapters: Sequence[str] = (), adapter_prob: float = 0.5,
                 model: Optional[str] = None,
                 ttft_deadline_s: Optional[float] = None) -> List[Arrival]:
    out = []
    for i, t in enumerate(times):
        adapter = None
        if adapters and rng.random() < adapter_prob:
            adapter = adapters[int(rng.integers(len(adapters)))]
        out.append(Arrival(float(t), prompt_len, max_new_tokens, adapter,
                           seed=int(rng.integers(2**31 - 1)), model=model,
                           ttft_deadline_s=ttft_deadline_s))
    return out


def poisson_trace(rate: float, horizon: float, *, seed: int = 0,
                  prompt_len: int = 8, max_new_tokens: int = 6,
                  adapters: Sequence[str] = (), adapter_prob: float = 0.5,
                  model: Optional[str] = None,
                  ttft_deadline_s: Optional[float] = None) -> List[Arrival]:
    """Homogeneous Poisson arrivals at ``rate`` req/s over ``horizon`` s."""
    rng = np.random.default_rng(seed)
    times, t = [], 0.0
    while True:
        t += rng.exponential(1.0 / max(rate, 1e-9))
        if t >= horizon:
            break
        times.append(t)
    return _materialize(times, rng, prompt_len=prompt_len,
                        max_new_tokens=max_new_tokens, adapters=adapters,
                        adapter_prob=adapter_prob, model=model,
                        ttft_deadline_s=ttft_deadline_s)


def gamma_trace(rate: float, horizon: float, *, burstiness: float = 4.0,
                seed: int = 0, prompt_len: int = 8, max_new_tokens: int = 6,
                adapters: Sequence[str] = (), adapter_prob: float = 0.5,
                model: Optional[str] = None,
                ttft_deadline_s: Optional[float] = None) -> List[Arrival]:
    """Gamma-renewal arrivals with mean rate ``rate`` and CV² = burstiness.

    shape k = 1/burstiness < 1 makes inter-arrivals heavy at zero (bursts)
    with occasional long gaps; burstiness = 1 degenerates to Poisson.
    """
    shape = 1.0 / max(burstiness, 1e-6)
    scale = 1.0 / (max(rate, 1e-9) * shape)   # mean = shape*scale = 1/rate
    rng = np.random.default_rng(seed)
    times, t = [], 0.0
    while True:
        t += rng.gamma(shape, scale)
        if t >= horizon:
            break
        times.append(t)
    return _materialize(times, rng, prompt_len=prompt_len,
                        max_new_tokens=max_new_tokens, adapters=adapters,
                        adapter_prob=adapter_prob, model=model,
                        ttft_deadline_s=ttft_deadline_s)


def burst_wave_trace(n_requests: int, *, base_rate: float = 0.5,
                     wave_rate: float = 20.0, wave_at: float = 2.0,
                     wave_len: float = 2.0, seed: int = 0,
                     prompt_len: int = 8, max_new_tokens: int = 6,
                     adapters: Sequence[str] = (), adapter_prob: float = 0.5,
                     model: Optional[str] = None,
                     ttft_deadline_s: Optional[float] = None
                     ) -> List[Arrival]:
    """Quiet Poisson base load with one sudden wave of ``wave_rate`` starting
    at ``wave_at`` — the fleet-cold-start scenario (stops after
    ``n_requests`` total)."""
    rng = np.random.default_rng(seed)
    times, t = [], 0.0
    while len(times) < n_requests:
        in_wave = wave_at <= t < wave_at + wave_len
        r = wave_rate if in_wave else base_rate
        dt = rng.exponential(1.0 / max(r, 1e-9))
        # don't let a quiet-phase gap jump the wave start
        if not in_wave and t < wave_at < t + dt:
            t = wave_at
            continue
        t += dt
        times.append(t)
    return _materialize(times, rng, prompt_len=prompt_len,
                        max_new_tokens=max_new_tokens, adapters=adapters,
                        adapter_prob=adapter_prob, model=model,
                        ttft_deadline_s=ttft_deadline_s)


def merge_traces(*traces: Sequence[Arrival]) -> List[Arrival]:
    """Interleave per-model/per-adapter traces into one time-sorted stream
    (each input is already sorted; stable across equal times)."""
    return list(heapq.merge(*traces, key=lambda a: a.time))


def arrival_stream(trace: Iterable[Arrival]) -> Iterator[Arrival]:
    """Time-ordered arrival iterator for ``ClusterRouter.run``.

    Lists/tuples are sorted here (the semantics ``run`` always had); any
    other iterable is assumed already time-ordered and passed through
    lazily — the streaming contract that lets ``iter_azure_trace`` replay
    a million-row day without ever materializing it.
    """
    if isinstance(trace, (list, tuple)):
        return iter(sorted(trace, key=lambda a: a.time))
    return iter(trace)


# ---------------------------------------------------------------------------
# Azure Functions trace ingestion
# ---------------------------------------------------------------------------

def load_azure_trace(path: str, *, minute_s: float = 60.0,
                     rate_scale: float = 1.0, prompt_len: int = 8,
                     max_new_tokens: int = 6,
                     models: Sequence[str] = (),
                     adapters: Sequence[Optional[str]] = (None,),
                     ttft_deadline_s: Optional[float] = None,
                     max_requests: Optional[int] = None,
                     seed: int = 0) -> List[Arrival]:
    """Convert the public Azure Functions invocation-count CSV shape into
    ``Arrival``s (the real-workload replay ROADMAP names).

    The dataset (Shahrad et al., ATC'20) is one row per function —
    ``HashOwner,HashApp,HashFunction,Trigger,1..1440`` — where the numeric
    columns are per-minute invocation counts.  Mapping:

    * every numeric-named column is one trace minute; minute ``m`` spans
      ``[(m-1)*minute_s, m*minute_s)`` seconds (shrink ``minute_s`` to
      time-compress a day onto a bench horizon);
    * per-function per-minute counts are scaled by ``rate_scale`` and
      rounded stochastically (a count of 2.4 yields 2 arrivals plus one
      more with p=0.4), then placed uniformly inside the minute;
    * functions map deterministically (sorted by their hash triple) onto
      the provided ``models``/``adapters`` round-robin — the per-function
      → adapter/model mapping PipeBoost's shared-base-model premise
      (§2.1) implies.  Empty ``models`` leaves ``Arrival.model`` None
      (single-pool replay); ``adapters`` defaults to base-only.

    Deterministic in ``seed``; arrivals return time-sorted, optionally
    truncated to the first ``max_requests``.
    """
    rng = np.random.default_rng(seed)
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    if not rows:
        return []
    minute_cols = sorted((c for c in rows[0] if c and c.strip().isdigit()),
                         key=int)
    if not minute_cols:
        raise ValueError(f"{path}: no per-minute count columns "
                         "(expected the Azure Functions CSV shape)")
    rows.sort(key=lambda r: (r.get("HashOwner", ""), r.get("HashApp", ""),
                             r.get("HashFunction", "")))
    out: List[Arrival] = []
    for fi, row in enumerate(rows):
        model = models[fi % len(models)] if models else None
        adapter = adapters[fi % len(adapters)] if adapters else None
        for col in minute_cols:
            raw = (row.get(col) or "0").strip()
            scaled = float(raw or 0) * rate_scale
            n = int(scaled) + (1 if rng.random() < scaled - int(scaled)
                               else 0)
            if n <= 0:
                continue
            # minute columns are 1-based day minutes; honor gaps and
            # trimmed excerpts (column "10" IS minute 10, wherever it
            # sits in the header)
            t0 = (int(col) - 1) * minute_s
            for t in sorted(t0 + rng.random(n) * minute_s):
                out.append(Arrival(float(t), prompt_len, max_new_tokens,
                                   adapter,
                                   seed=int(rng.integers(2**31 - 1)),
                                   model=model,
                                   ttft_deadline_s=ttft_deadline_s))
    out.sort(key=lambda a: a.time)
    return out[:max_requests] if max_requests is not None else out


def iter_azure_trace(path: str, *, minute_s: float = 60.0,
                     rate_scale: float = 1.0, prompt_len: int = 8,
                     max_new_tokens: int = 6,
                     models: Sequence[str] = (),
                     adapters: Sequence[Optional[str]] = (None,),
                     ttft_deadline_s: Optional[float] = None,
                     max_requests: Optional[int] = None,
                     seed: int = 0) -> Iterator[Arrival]:
    """Streaming, minute-major counterpart of :func:`load_azure_trace`.

    Same CSV shape and same per-minute model (scaled counts, stochastic
    rounding, uniform placement, deterministic function→model/adapter
    round-robin), but generated one *day minute* at a time and yielded in
    time order — a full day ``rate_scale``-d to a million arrivals is
    never resident as a list.  Feed it straight to ``ClusterRouter.run``
    (the event engine consumes arrivals lazily).

    Note: a distinct generator, not a drop-in RNG-replay of
    ``load_azure_trace`` — the minute-major draw order yields different
    (equally distributed) jitter for the same seed.
    """
    rng = np.random.default_rng(seed)
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))     # one row per FUNCTION: small
    if not rows:
        return
    minute_cols = sorted((c for c in rows[0] if c and c.strip().isdigit()),
                         key=int)
    if not minute_cols:
        raise ValueError(f"{path}: no per-minute count columns "
                         "(expected the Azure Functions CSV shape)")
    rows.sort(key=lambda r: (r.get("HashOwner", ""), r.get("HashApp", ""),
                             r.get("HashFunction", "")))
    fns = [(models[fi % len(models)] if models else None,
            adapters[fi % len(adapters)] if adapters else None, row)
           for fi, row in enumerate(rows)]
    emitted = 0
    for col in minute_cols:
        t0 = (int(col) - 1) * minute_s
        batch: List[Arrival] = []
        for model, adapter, row in fns:
            raw = (row.get(col) or "0").strip()
            scaled = float(raw or 0) * rate_scale
            n = int(scaled) + (1 if rng.random() < scaled - int(scaled)
                               else 0)
            if n <= 0:
                continue
            times = t0 + rng.random(n) * minute_s
            seeds = rng.integers(2**31 - 1, size=n)
            batch.extend(Arrival(float(t), prompt_len, max_new_tokens,
                                 adapter, seed=int(s), model=model,
                                 ttft_deadline_s=ttft_deadline_s)
                         for t, s in zip(times, seeds))
        batch.sort(key=lambda a: a.time)
        for a in batch:
            if max_requests is not None and emitted >= max_requests:
                return
            emitted += 1
            yield a


# ---------------------------------------------------------------------------
# Replayable trace format
# ---------------------------------------------------------------------------

def save_trace(path: str, trace: Sequence[Arrival]) -> None:
    """Write a trace as versioned JSON (replayable, diffable)."""
    with open(path, "w") as f:
        json.dump({"version": 1, "arrivals": [asdict(a) for a in trace]},
                  f, indent=1)


def load_trace(path: str) -> List[Arrival]:
    """Read a ``save_trace`` JSON file back into ``Arrival``s."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("version") != 1:
        raise ValueError(f"unknown trace version {doc.get('version')!r}")
    return [Arrival(**a) for a in doc["arrivals"]]


def prompt_tokens(arrival: Arrival, vocab_size: int) -> np.ndarray:
    """Deterministic prompt content for an arrival (seed-addressed).

    With ``prefix_len`` > 0 the first ``prefix_len`` tokens come from
    ``prefix_seed`` (arrivals sharing it share the exact token prefix —
    the shared-system-prompt shape the prefix cache exploits) and the
    remainder from the per-request ``seed``.  ``prefix_len`` 0 keeps the
    original single-draw behavior bit-for-bit.
    """
    hi = min(vocab_size, 250)
    n_pre = min(max(0, arrival.prefix_len), arrival.prompt_len) \
        if arrival.prefix_seed is not None else 0
    if n_pre == 0:
        rng = np.random.default_rng(arrival.seed)
        return rng.integers(0, hi,
                            size=arrival.prompt_len).astype(np.int64)
    pre = np.random.default_rng(arrival.prefix_seed) \
        .integers(0, hi, size=n_pre).astype(np.int64)
    sfx = np.random.default_rng(arrival.seed) \
        .integers(0, hi, size=arrival.prompt_len - n_pre).astype(np.int64)
    return np.concatenate([pre, sfx])


def repeated_prefix_trace(n: int, *, prefix_len: int, suffix_len: int,
                          n_prefixes: int = 1, gap_s: float = 0.2,
                          max_new_tokens: int = 6, seed: int = 0,
                          model: Optional[str] = None,
                          adapter: Optional[str] = None,
                          ttft_deadline_s: Optional[float] = None
                          ) -> List[Arrival]:
    """Evenly spaced arrivals whose prompts cycle over ``n_prefixes``
    shared token prefixes with per-request suffixes — the workload shape
    (system prompt + unique user turn) the cross-request prefix cache is
    built for.  Deterministic in ``seed``; arrival ``i`` lands at
    ``i * gap_s`` and reuses prefix ``i % n_prefixes``.

    Pick a ``gap_s`` OFF the router's tick grid (not a multiple of
    ``tick_s`` — same rule as chaos event times): an arrival exactly on
    a tick boundary can be admitted on different ticks by the tick and
    event engines (their clocks accumulate float error differently)."""
    out = []
    for i in range(n):
        out.append(Arrival(
            time=i * gap_s, prompt_len=prefix_len + suffix_len,
            max_new_tokens=max_new_tokens, adapter=adapter,
            seed=seed + i, model=model, ttft_deadline_s=ttft_deadline_s,
            prefix_len=prefix_len, prefix_seed=10_000 + (i % n_prefixes)))
    return out


# ---------------------------------------------------------------------------
# Chaos schedules (seeded fault injection)
# ---------------------------------------------------------------------------

CHAOS_KINDS = ("crash", "partial_crash", "rejoin", "source_crash",
               "fill_crash")

# the load-stage fault vocabulary: kinds that target the multicast
# scale-out path — a warm server mid-send ("source_crash") or a spawning
# receiver mid-fill ("fill_crash").  Both execute as whole-server crashes
# (the multicast manager re-roots around whichever role the victim held);
# keeping them distinct kinds makes schedules self-describing and lets
# random_chaos target the load stage on purpose.
LOAD_CHAOS_KINDS = ("source_crash", "fill_crash")


@dataclass(frozen=True)
class ChaosEvent:
    """One scheduled fault: kill a whole server, kill some of its devices,
    or bring a server / a device list back.

    Load-stage kinds (``source_crash`` / ``fill_crash``) name the victim's
    role in a multicast scale-out — a warm load source vs a receiver
    mid-fill — and execute as whole-server crashes; the multicast manager
    re-roots transfers around the victim either way.

    ``devices`` names the affected device ids for ``partial_crash`` and
    for a device-granular ``rejoin``; empty means the whole server.
    Times should sit OFF the router's tick grid (like arrival times) so
    the tick and event engines agree on the applying tick bit-for-bit.
    """
    time: float
    kind: str                       # one of CHAOS_KINDS
    server: int
    devices: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.kind not in CHAOS_KINDS:
            raise ValueError(f"unknown chaos kind {self.kind!r}; "
                             f"known kinds: {CHAOS_KINDS}")
        object.__setattr__(self, "devices", tuple(self.devices))


@dataclass
class ChaosSchedule:
    """A replayable fault-injection script, executed by
    ``ClusterRouter.run(chaos=...)`` identically under the tick and event
    engines: an event applies at the first tick whose (pre-advance) clock
    has reached its time — exactly the arrival-admission rule."""
    events: List[ChaosEvent] = field(default_factory=list)

    def __post_init__(self):
        self.events = sorted(self.events, key=lambda e: e.time)

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)


# chaos schema versions: 1 = the original crash/partial_crash/rejoin
# vocabulary; 2 = adds the load-stage kinds (LOAD_CHAOS_KINDS).  save_chaos
# stamps the lowest version that can express the schedule so old readers
# keep loading old-vocabulary files.
CHAOS_SCHEMA_VERSIONS = (1, 2)


def save_chaos(path: str, schedule: ChaosSchedule) -> None:
    """Write a chaos schedule as versioned JSON (replayable, diffable).

    Schedules using only the original kinds save as version 1 (readable
    by pre-multicast loaders); any load-stage event bumps the file to
    version 2."""
    version = 2 if any(e.kind in LOAD_CHAOS_KINDS
                       for e in schedule.events) else 1
    with open(path, "w") as f:
        json.dump({"version": version,
                   "events": [asdict(e) for e in schedule.events]},
                  f, indent=1)


def load_chaos(path: str) -> ChaosSchedule:
    """Read a ``save_chaos`` JSON file back into a ``ChaosSchedule``.

    Accepts schema versions ``CHAOS_SCHEMA_VERSIONS``; unknown versions
    and unknown event kinds raise ``ValueError``s that name the file,
    the offending event, and the accepted vocabulary."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("version") not in CHAOS_SCHEMA_VERSIONS:
        raise ValueError(
            f"{path}: unknown chaos version {doc.get('version')!r}; "
            f"this reader understands versions {CHAOS_SCHEMA_VERSIONS}")
    events = []
    for i, e in enumerate(doc.get("events", [])):
        try:
            events.append(ChaosEvent(**e))
        except (TypeError, ValueError) as exc:
            raise ValueError(f"{path}: bad chaos event #{i} {e!r}: {exc}") \
                from exc
    return ChaosSchedule(events)


def random_chaos(n_faults: int, horizon: float, n_servers: int, *,
                 seed: int = 0, n_devices: int = 0,
                 partial_prob: float = 0.0,
                 load_fault_prob: float = 0.0,
                 rejoin_delay_s: float = 1.0,
                 tick_s: float = 0.05) -> ChaosSchedule:
    """Seeded random fault script: ``n_faults`` crashes uniformly over
    ``(0, horizon)``, each paired with a rejoin ``rejoin_delay_s`` later.

    With ``partial_prob`` > 0 (needs ``n_devices``), a fault is a
    ``partial_crash`` of a random proper device subset, rejoined at device
    granularity.  With ``load_fault_prob`` > 0, a fault targets the
    multicast load stage instead: a ``source_crash`` or ``fill_crash``
    (50/50), paired with a whole-server rejoin like a plain crash.
    Event times are nudged off the ``tick_s`` grid so tick and event
    engines replay them on the same tick.  Deterministic by ``seed``.
    """
    rng = np.random.default_rng(seed)
    events: List[ChaosEvent] = []
    for _ in range(n_faults):
        t = float(rng.uniform(0.0, horizon))
        if abs(t / tick_s - round(t / tick_s)) < 1e-6:   # off-grid nudge
            t += 0.37 * tick_s
        sid = int(rng.integers(n_servers))
        if rng.random() < load_fault_prob:
            kind = LOAD_CHAOS_KINDS[int(rng.integers(2))]
            events.append(ChaosEvent(t, kind, sid))
            events.append(ChaosEvent(t + rejoin_delay_s, "rejoin", sid))
            continue
        partial = (n_devices > 1 and rng.random() < partial_prob)
        if partial:
            k = int(rng.integers(1, n_devices))          # proper subset
            devs = tuple(sorted(rng.choice(n_devices, size=k,
                                           replace=False).tolist()))
            events.append(ChaosEvent(t, "partial_crash", sid, devs))
            events.append(ChaosEvent(t + rejoin_delay_s, "rejoin", sid,
                                     devs))
        else:
            events.append(ChaosEvent(t, "crash", sid))
            events.append(ChaosEvent(t + rejoin_delay_s, "rejoin", sid))
    return ChaosSchedule(events)
