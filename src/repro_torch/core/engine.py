"""PipeBoost engine: pipeline-parallel loading over logical devices,
inference once a viable chain exists, the strategy switch, crash injection
and recovery (the port of ``repro/core/engine.py``, paper §4.1–§4.4).

As in the reference, the devices are bookkeeping entities: loading records
which segment each device holds (``engine.py:142-153`` of the reference)
and whose K/V each device owns, while the whole model is already resident
on the one card, and inference runs the full model.  The engine owns
correctness: a request served before full load produces exactly the tokens
of a fully loaded model, and a crash and recovery rebuild exactly the
state a fresh prefill would give (``core.kv_reconstruct``).

The engine's own ``prefill`` and ``decode`` (used by ``generate`` and the
launcher's ``--crash-at``) run eagerly; the serving batcher's decode step
is the captured one.

Pipeline prefill (§4.3, ``enable_pipeline_prefill``): while the engine is
in pipeline strategy, a prefill whose rows split over the ('data',
'stage') grid runs the belt of ``distributed/pipeline.py``, stage i on
device (d, i) of the grid, and its cache feeds the same decode step the
single prefill's does.  Without an explicit grid the engine sizes one over
``visible_devices()``, so on one card it keeps the single prefill, as the
reference does on one XLA device.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Set, Tuple)

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import analytic
from repro_torch.core.kv_reconstruct import reconstruct_cache
from repro_torch.core.planner import (LoadPlan, make_plan, reassign,
                                      viable_chain)
from repro_torch.distributed import pipeline
from repro_torch.lora.adapters import LoRAAdapter, merge_lora
from repro_torch.models import transformer


class EngineError(RuntimeError):
    pass


@dataclass
class DeviceState:
    idx: int
    alive: bool = True
    loaded: Set[int] = field(default_factory=set)      # fully-loaded segments
    kv_segments: Set[int] = field(default_factory=set)  # segments whose KV
                                                         # this device owns


@dataclass
class LoadRound:
    """Accounting for one background-fill round (overlapped cold start)."""
    idx: int
    t_start: float                       # seconds since engine construction
    wall_s: float                        # wall-clock spent inside the round
    bytes: int                           # segment bytes transferred this round
    segments: List[Tuple[int, int]]      # (device, segment) loads
    source: str = "host"                 # "host" fill round or "peer"
                                         # multicast delivery


@dataclass
class EngineStatus:
    ready: bool
    fully_loaded: bool
    strategy: str
    alive: List[int]
    loaded: Dict[int, List[int]]
    chain: Optional[List[Tuple[int, int]]]
    time_to_ready: Optional[float] = None
    time_to_fully_loaded: Optional[float] = None
    loaded_bytes: int = 0
    total_bytes: int = 0
    n_rounds: int = 0


class PipeBoostEngine:
    """State machine + inference for one GPU-server analogue."""

    def __init__(self, cfg: ArchConfig, params, n_devices: int,
                 n_segments: Optional[int] = None, max_len: int = 256,
                 adapters: Optional[Dict[str, LoRAAdapter]] = None,
                 segments_per_round: int = 1):
        self.cfg = cfg
        self._full_params = params          # "checkpoint in DRAM"
        self.n_devices = n_devices
        self.n_segments = n_segments
        self.plan: LoadPlan = make_plan(analytic.layer_bytes_list(cfg),
                                        n_devices, n_segments)
        self.devices = [DeviceState(i) for i in range(n_devices)]
        self.max_len = max_len
        self.strategy = "pipeline"          # -> "single" after switch
        self.adapters = adapters or {}
        self.active_adapter: Optional[str] = None
        self._merged_params = params        # params w/ active adapter merged
        self._cache: Optional[Dict] = None
        self._tokens_seen: Optional[torch.Tensor] = None
        self._prefill_shapes: Set[Tuple[int, ...]] = set()
        self.events: List[Tuple[str, Any]] = []
        # loading is re-entrant (background thread or generator-stepped)
        # and accounted per round
        self.segments_per_round = max(1, segments_per_round)
        self._load_lock = threading.RLock()
        self._fill_thread: Optional[threading.Thread] = None
        self._fill_stop = threading.Event()
        # remembered so a repartition can hand the fill to a fresh thread
        # over the new plan (same cadence and budget)
        self._fill_interval_s = 0.0
        self._fill_budget: Optional[int] = None
        # the pipeline prefill belt: off until enable_pipeline_prefill
        self._pipe_enabled = False
        self._pipe_requested = False
        self._pipe_mesh: Optional[pipeline.StageMesh] = None
        self._pipe_pool: List[torch.device] = []   # a repartition re-splits
        self._pipe_n_stages = 0
        self._pipe_n_micro = 0
        self._pipe_fns: Dict[Tuple[int, int, int], Callable] = {}
        self.prefill_backend_used: Optional[str] = None
        self._reset_load_accounting()

    # ---------------- loading ------------------------------------------------

    def _record_event(self, tag: str, payload: Any) -> None:
        """Append to the event log under the load lock (the fill thread
        appends ``load`` events concurrently)."""
        with self._load_lock:
            self.events.append((tag, payload))

    def _reset_load_accounting(self) -> None:
        with self._load_lock:
            self._t0 = time.perf_counter()
            self.rounds: List[LoadRound] = []
            self.time_to_ready: Optional[float] = None
            self.time_to_fully_loaded: Optional[float] = None

    def load_next_segment(self, device: int) -> Optional[int]:
        """Advance device's rotated loading order by one segment."""
        with self._load_lock:
            d = self.devices[device]
            if not d.alive:
                raise EngineError(f"device {device} is dead")
            for s in self.plan.order[device]:
                if s not in d.loaded:
                    d.loaded.add(s)
                    self.events.append(("load", (device, s)))
                    return s
            return None

    def load_round(self, budget: Optional[int] = None) -> Optional[LoadRound]:
        """One loading round across alive devices: each loads up to
        ``budget`` segments (default: the engine's ``segments_per_round``).
        Safe to call from a background thread while serving.  Returns the
        round's accounting, or None when nothing was left to load."""
        budget = budget if budget is not None else self.segments_per_round
        t0 = time.perf_counter()
        loads: List[Tuple[int, int]] = []
        round_: Optional[LoadRound] = None
        with self._load_lock:
            for d in self.devices:
                if not d.alive:
                    continue
                for _ in range(budget):
                    s = self.load_next_segment(d.idx)
                    if s is None:
                        break
                    loads.append((d.idx, s))
            if loads:
                nbytes = sum(self.plan.segments[s].bytes for _, s in loads)
                round_ = LoadRound(len(self.rounds), t0 - self._t0,
                                   time.perf_counter() - t0, nbytes, loads)
                self.rounds.append(round_)
            # stamp the two cold-start milestones the moment they flip
            if self.time_to_ready is None and self.ready:
                self.time_to_ready = time.perf_counter() - self._t0
            if self.time_to_fully_loaded is None and self.fully_loaded:
                self.time_to_fully_loaded = time.perf_counter() - self._t0
        return round_

    def load_segment(self, device: int, segment: int,
                     source: str = "peer") -> Optional[LoadRound]:
        """Load one *specific* segment onto one device, out of the rotated
        fill order — the multicast delivery path: a peer finished streaming
        this segment, so it lands here without a host read.  Records a
        ``LoadRound`` tagged with ``source`` and stamps the ready and
        fully-loaded milestones as ``load_round`` does.  Returns None when
        the device already held the segment."""
        t0 = time.perf_counter()
        with self._load_lock:
            d = self.devices[device]
            if not d.alive:
                raise EngineError(f"device {device} is dead")
            round_: Optional[LoadRound] = None
            if segment not in d.loaded:
                d.loaded.add(segment)
                self.events.append(("load", (device, segment)))
                round_ = LoadRound(
                    len(self.rounds), t0 - self._t0,
                    time.perf_counter() - t0,
                    self.plan.segments[segment].bytes,
                    [(device, segment)], source)
                self.rounds.append(round_)
            if self.time_to_ready is None and self.ready:
                self.time_to_ready = time.perf_counter() - self._t0
            if self.time_to_fully_loaded is None and self.fully_loaded:
                self.time_to_fully_loaded = time.perf_counter() - self._t0
        return round_

    def peer_loaded_bytes(self) -> int:
        """Bytes that arrived by peer multicast rather than host reads."""
        with self._load_lock:
            return sum(r.bytes for r in self.rounds if r.source == "peer")

    def fill_steps(self, budget: Optional[int] = None) -> Iterator[LoadRound]:
        """Generator-step fill: yields one ``LoadRound`` per round until
        the model is fully loaded."""
        while True:
            round_ = self.load_round(budget)
            if round_ is None:
                return
            yield round_

    def start_fill(self, interval_s: float = 0.0,
                   budget: Optional[int] = None) -> threading.Thread:
        """Start the background fill: a daemon thread runs ``load_round``
        until fully loaded (or ``stop_fill``), overlapping serving on the
        main thread.  Loading is bookkeeping: the thread makes no CUDA
        call, so it cannot disturb a decode step being captured."""
        if self._fill_thread is not None and self._fill_thread.is_alive():
            return self._fill_thread
        self._fill_interval_s = interval_s
        self._fill_budget = budget
        self._fill_stop.clear()

        def _run():
            while not self._fill_stop.is_set():
                if not self.load_round(budget):
                    return
                if interval_s > 0:
                    self._fill_stop.wait(interval_s)

        t = threading.Thread(target=_run, name="pipeboost-fill", daemon=True)
        self._fill_thread = t
        t.start()
        return t

    def stop_fill(self, join: bool = True) -> None:
        self._fill_stop.set()
        if join and self._fill_thread is not None:
            self._fill_thread.join(timeout=30.0)
        self._fill_thread = None

    @property
    def fill_running(self) -> bool:
        return self._fill_thread is not None and self._fill_thread.is_alive()

    def loaded_map(self) -> Dict[int, List[int]]:
        with self._load_lock:
            return {d.idx: sorted(d.loaded) for d in self.devices if d.alive}

    def chain(self) -> Optional[List[Tuple[int, int]]]:
        with self._load_lock:
            return viable_chain(self.plan, self.loaded_map(),
                                [d.idx for d in self.devices if d.alive])

    @property
    def ready(self) -> bool:
        return self.chain() is not None

    def rounds_to_ready(self, budget: Optional[int] = None) -> int:
        """Predicted ``load_round`` calls until a viable chain exists (0
        when ready); simulated on copies of the loaded sets.  A large
        sentinel when no amount of loading completes a chain."""
        budget = budget if budget is not None else self.segments_per_round
        with self._load_lock:
            alive = [d.idx for d in self.devices if d.alive]
            loaded = {d.idx: set(d.loaded) for d in self.devices if d.alive}
            if not alive:
                return 1 << 20
            if viable_chain(self.plan, {i: sorted(s) for i, s in
                                        loaded.items()}, alive) is not None:
                return 0
            for rounds in range(1, len(self.plan.segments) + 1):
                for i in alive:
                    todo = [s for s in self.plan.order[i]
                            if s not in loaded[i]][:max(1, budget)]
                    loaded[i].update(todo)
                if viable_chain(self.plan, {i: sorted(s) for i, s in
                                            loaded.items()},
                                alive) is not None:
                    return rounds
            return 1 << 20

    @property
    def fully_loaded(self) -> bool:
        with self._load_lock:
            n = len(self.plan.segments)
            return all(len(d.loaded) == n for d in self.devices if d.alive)

    def loaded_bytes(self) -> int:
        """Bytes resident across alive devices (per-device copies)."""
        with self._load_lock:
            return sum(self.plan.segments[s].bytes
                       for d in self.devices if d.alive for s in d.loaded)

    def total_bytes(self) -> int:
        """Bytes every alive device must eventually hold."""
        with self._load_lock:
            model = sum(s.bytes for s in self.plan.segments)
            return model * sum(1 for d in self.devices if d.alive)

    def cold_start_stats(self) -> Dict[str, Any]:
        """Flat cold-start accounting for metrics/benchmarks."""
        with self._load_lock:
            return {
                "time_to_ready": self.time_to_ready,
                "time_to_fully_loaded": self.time_to_fully_loaded,
                "loaded_bytes": self.loaded_bytes(),
                "total_bytes": self.total_bytes(),
                "n_rounds": len(self.rounds),
                "round_bytes": [r.bytes for r in self.rounds],
            }

    def status(self) -> EngineStatus:
        """One consistent snapshot, taken under the load lock."""
        with self._load_lock:
            return EngineStatus(self.ready, self.fully_loaded, self.strategy,
                                [d.idx for d in self.devices if d.alive],
                                self.loaded_map(), self.chain(),
                                self.time_to_ready,
                                self.time_to_fully_loaded,
                                self.loaded_bytes(), self.total_bytes(),
                                len(self.rounds))

    # ---------------- adapters (merged-LoRA, §4.3.2) -------------------------

    def switch_adapter(self, name: Optional[str]):
        """Swap the merged weights (the LoRA-merge kernel on the card)."""
        if name == self.active_adapter:
            return
        params = self._full_params
        if name is not None:
            if name not in self.adapters:
                raise EngineError(f"unknown adapter {name!r}")
            params = merge_lora(params, self.adapters[name])
        self.active_adapter = name
        self._merged_params = params
        self._record_event("adapter_switch", name)

    # ---------------- inference ---------------------------------------------

    def _segment_layer_mask(self, segs: Set[int]) -> List[bool]:
        """Per global layer: is the layer inside one of ``segs``."""
        mask = [False] * self.cfg.n_layers
        with self._load_lock:        # a repartition may swap self.plan
            for s in segs:
                seg = self.plan.segments[s]
                for i in range(seg.layer_start, seg.layer_end):
                    mask[i] = True
        return mask

    def lost_state_layers(self, device_ids: Sequence[int]) -> List[bool]:
        """Per global layer: True if its KV/recurrent state lives on one of
        ``device_ids`` under the current serving chain (each chained
        segment's state sits on its device; with no chain nothing is
        owned).  Call it BEFORE ``crash`` marks the devices dead: the chain
        is computed over alive devices.  A partial crash then rebuilds only
        these layers (paper §4.4.2)."""
        dead = set(device_ids)
        ch = self.chain()
        if ch is None:
            return [False] * self.cfg.n_layers
        return self._segment_layer_mask({seg for dev, seg in ch
                                         if dev in dead})

    def _own_kv(self, chain) -> None:
        """KV ownership follows the serving chain."""
        with self._load_lock:
            for d in self.devices:
                d.kv_segments = set()
            for dev, seg in chain:
                self.devices[dev].kv_segments.add(seg)

    def _surviving_state(self) -> List[bool]:
        """Per global layer: does an alive device own its state."""
        surviving: Set[int] = set()
        with self._load_lock:
            for d in self.devices:
                if d.alive:
                    surviving |= d.kv_segments
        return self._segment_layer_mask(surviving)

    # ---------------- the pipeline prefill belt (§4.3) ------------------------

    def enable_pipeline_prefill(self, mesh: Optional[pipeline.StageMesh]
                                = None, n_micro: int = 2) -> bool:
        """Opt the TTFT-critical prefill into the pipeline belt
        (``distributed/pipeline.py``): stage i runs the layers of the
        segments device i has loaded, so the first token computes on the
        partial chain while later segments keep loading.

        Without ``mesh`` the ('data', 'stage') grid is sized over
        ``visible_devices()``: the most stages that divide both the layer
        count and the device count.  Returns False (the engine keeps its
        single prefill) for fewer than 2 devices, a hybrid layer stack or
        a layer count no stage count divides."""
        kinds = set(self.cfg.layer_kinds())
        if len(kinds) != 1 or next(iter(kinds)) not in ("attn", "moe",
                                                          "ssm"):
            return False
        L = self.cfg.n_layers
        if mesh is None:
            devs = pipeline.visible_devices()
            if len(devs) < 2:
                return False
            n_stages = next((s for s in range(min(len(devs), L), 1, -1)
                             if L % s == 0 and len(devs) % s == 0), 0)
            if not n_stages:
                return False
            mesh = pipeline.stage_mesh(n_stages, len(devs) // n_stages,
                                       devices=devs)
        else:
            n_stages = mesh.shape["stage"]
            if L % n_stages:
                return False
        self._pipe_mesh = mesh
        self._pipe_pool = mesh.flat()
        self._pipe_n_stages = n_stages
        self._pipe_n_micro = max(1, n_micro)
        self._pipe_fns = {}
        self._pipe_enabled = True
        self._pipe_requested = True
        return True

    def serving_pipeline_fits(self, P: int, S: int) -> bool:
        """Shape pre-check for ``serving_pipeline_prefill`` (the batcher's
        dispatch): the rows must split over the grid's data rows and each
        row's share into the microbatches."""
        if not self._pipe_enabled or self._pipe_mesh is None:
            return False
        n_data = self._pipe_mesh.shape["data"]
        return P % n_data == 0 and (P // n_data) % self._pipe_n_micro == 0

    def wire_pipeline_prefill(self, batcher) -> None:
        """Point a ``ContinuousBatcher``'s admission prefills at this
        engine's belt while the engine is in pipeline strategy (the wiring
        ``ClusterServer`` and the launcher make after a successful
        ``enable_pipeline_prefill``)."""
        batcher.set_pipeline_prefill(self.serving_pipeline_prefill,
                                     fits=self.serving_pipeline_fits)
        batcher.prefill_backend = (
            lambda: "pipeline" if self.strategy == "pipeline" else "single")

    def _pipeline_fits(self, batch: Dict) -> bool:
        return (self.strategy == "pipeline"
                and self.serving_pipeline_fits(*batch["tokens"].shape))

    def _pipeline_prefill_fn(self, B: int, S: int) -> Callable:
        """The belt for (stage count, B, S), built once: a repartition back
        to a stage count seen before reuses its belt, so the count
        (``pipeline_prefill_compiles``) grows with distinct stage plans
        and shapes, never with crash events."""
        key = (self._pipe_n_stages, B, S)
        if key not in self._pipe_fns:
            self._pipe_fns[key] = pipeline.build_pipeline_prefill(
                self.cfg, n_stages=self._pipe_n_stages,
                n_micro=self._pipe_n_micro, mesh=self._pipe_mesh,
                seq_len=S, max_len=self.max_len, return_cache=True)
        return self._pipe_fns[key]

    def serving_pipeline_prefill(self, params, batch: Dict):
        """``ContinuousBatcher.set_pipeline_prefill``'s contract: an
        admission prefill (right-padded rows and their ``last_index``)
        through the belt -> (logits (P, V), cache) with the layout of
        ``forward(mode="prefill")``, ``pos`` at ``last_index + 1``."""
        B, S = batch["tokens"].shape
        return self._pipeline_prefill_fn(B, S)(params, batch)

    def _pipeline_fn_call(self, batch: Dict):
        """The strategy hand-off (§4.3.3): the belt leaves each stage's
        state in the one cache the decode step reads, with the single
        prefill's keys, shapes and dtypes, so the switch re-lays nothing
        and the decode step is the same."""
        return self.serving_pipeline_prefill(self._merged_params,
                                             {"tokens": batch["tokens"]})

    def prefill(self, batch: Dict) -> torch.Tensor:
        """Serve a prefill the moment a chain exists (after each device
        loaded only ~1/N of the model); runs eagerly.  In pipeline
        strategy with the belt enabled it runs the belt."""
        chain = self.chain()
        if chain is None:
            raise EngineError("no viable pipeline chain: model not ready")
        if self._pipeline_fits(batch):
            logits, self._cache = self._pipeline_fn_call(batch)
            self.prefill_backend_used = "pipeline"
        else:
            logits, self._cache = transformer.forward(
                self.cfg, self._merged_params, batch, mode="prefill",
                max_len=self.max_len)
            self._prefill_shapes.add(tuple(batch["tokens"].shape))
            self.prefill_backend_used = "single"
        self._tokens_seen = batch.get("tokens")
        self._own_kv(chain)
        with self._load_lock:
            self.events.append(("prefill", chain))
            self.events.append(("prefill_backend",
                                self.prefill_backend_used))
        return logits

    def decode(self, tokens: torch.Tensor) -> torch.Tensor:
        """One eager decode step of the prefilled batch (the serving
        batcher's step is the captured one)."""
        if self._cache is None:
            raise EngineError("prefill first")
        if self.strategy == "pipeline" and self.chain() is None:
            raise EngineError("pipeline chain broken — recover() first")
        logits, self._cache = transformer.decode_step(
            self.cfg, self._merged_params, {"tokens": tokens}, self._cache)
        if self._tokens_seen is not None:
            self._tokens_seen = torch.cat(
                [self._tokens_seen,
                 tokens.reshape(-1, 1).to(self._tokens_seen.dtype)], dim=1)
        return logits

    def compile_stats(self) -> Dict[str, int]:
        """The reference's compile counts of the engine's own paths: its
        decode runs eagerly (0 captures), ``prefill_compiles`` counts the
        distinct single-prefill shapes run and
        ``pipeline_prefill_compiles`` the belts built."""
        return {"decode_compiles": 0,
                "prefill_compiles": len(self._prefill_shapes),
                "pipeline_prefill_compiles": len(self._pipe_fns)}

    # ---------------- strategy switching (§4.3.3) ----------------------------

    def maybe_switch_strategy(self, request_rate: float,
                              crossover_rate: float = 0.0) -> bool:
        """Switch to per-device independent serving once every device
        holds the full model (and the rate argues for it)."""
        if self.strategy == "single":
            return False
        if self.fully_loaded and request_rate >= crossover_rate:
            self.strategy = "single"
            self._record_event("strategy_switch", "single")
            return True
        return False

    # ---------------- failures + recovery (§4.4) -----------------------------

    def crash(self, device_ids: Sequence[int]):
        """Mark devices dead.  A running background fill is stopped
        cleanly: the stop flag is raised before the devices are marked (a
        round in flight holds the load lock and lands whole), then the
        thread is joined outside the lock."""
        was_filling = self.fill_running
        if was_filling:
            self._fill_stop.set()
        with self._load_lock:
            for i in device_ids:
                self.devices[i].alive = False
        if was_filling:
            self.stop_fill(join=True)
        self._record_event("crash", list(device_ids))

    def restart(self, n_devices: Optional[int] = None):
        """Full server reboot (cluster rejoin): every device comes back
        alive and empty with a fresh rotated load plan; serving state is
        dropped."""
        self.stop_fill()
        with self._load_lock:
            if n_devices is not None:
                self.n_devices = n_devices
                self.n_segments = None  # segment override was per-dev-count
            self.plan = make_plan(analytic.layer_bytes_list(self.cfg),
                                  self.n_devices, self.n_segments)
            self.devices = [DeviceState(i) for i in range(self.n_devices)]
            self.strategy = "pipeline"
            self._cache = None
            self._tokens_seen = None
            self._reset_load_accounting()   # a rejoin is a fresh cold start
        self._record_event("restart", self.n_devices)

    def _revive_devices(self, device_ids: Sequence[int]) -> None:
        """Crashed devices come back alive with empty HBM (lock held)."""
        for i in device_ids:
            d = self.devices[i]
            if d.alive:
                continue
            d.alive = True
            d.loaded = set()
            d.kv_segments = set()

    def revive(self, device_ids: Sequence[int]):
        """Bring crashed devices back empty and re-plan the segment ring
        over the enlarged alive set; they load their spans on later
        ``load_round`` calls."""
        with self._load_lock:
            self._revive_devices(device_ids)
            alive = [d.idx for d in self.devices if d.alive]
            self.plan = reassign(self.plan, self.loaded_map(), alive)
        self._record_event("revive", list(device_ids))

    def _repartition_pipeline(self) -> int:
        """Re-split the belt for the alive-device count: the most stages
        that divide the layer stack and fit both the alive devices and the
        pool the engine's grid was built from, possibly over a SUBSET of
        the pool (``stage_mesh``), so 3 stages run after a 4 -> 3 shrink.
        With no split the engine falls back to the single prefill (decode
        is unaffected either way).  Built belts are kept: they are keyed
        by (n_stages, B, S).  Returns the stage count (0 when no belt was
        requested or none fits)."""
        if not self._pipe_requested:
            return self._pipe_n_stages if self._pipe_enabled else 0
        with self._load_lock:
            n_alive = sum(1 for d in self.devices if d.alive)
        L = self.cfg.n_layers
        n_stages = next((s for s in range(min(n_alive, len(self._pipe_pool),
                                              L), 1, -1) if L % s == 0), 0)
        if not n_stages:
            self._pipe_enabled = False
            self._pipe_mesh = None
            self._pipe_n_stages = 0
            return 0
        if n_stages != self._pipe_n_stages or not self._pipe_enabled:
            self._pipe_mesh = pipeline.stage_mesh(n_stages,
                                                  devices=self._pipe_pool)
            self._pipe_n_stages = n_stages
            self._pipe_enabled = True
        return n_stages

    def repartition(self, dead: Sequence[int] = (),
                    revive: Sequence[int] = ()) -> Dict[str, Any]:
        """Elastic in-flight repartition: re-split the pipeline over a
        CHANGED device set — shrink when devices die, widen when they
        rejoin — without draining in-flight work.

        Stops the background fill cleanly, applies the membership change and
        ``reassign``s contiguous spans over the new alive set, loads until a
        viable chain exists, re-lays live decode state with
        ``reconstruct_cache`` (only layers whose state died are recomputed,
        so the continued stream is unchanged and zero tokens are
        re-prefilled), and hands the fill to a fresh thread if one was
        running.  Returns a stats dict (also a ``repartition`` event)."""
        dead = [int(i) for i in dead]
        revive = [int(i) for i in revive]
        was_filling = self.fill_running
        if was_filling:
            self._fill_stop.set()
            self.stop_fill(join=True)
        with self._load_lock:
            for i in dead:
                self.devices[i].alive = False
            self._revive_devices(revive)
            alive = [d.idx for d in self.devices if d.alive]
            if not alive:
                raise EngineError("all devices dead")
            self.plan = reassign(self.plan, self.loaded_map(), alive)
        while self.chain() is None:
            if not self.load_round():
                raise EngineError("cannot complete chain after repartition")
        stats: Dict[str, Any] = {
            "dead": dead, "revive": revive, "n_alive": len(alive),
            "n_stages": self._repartition_pipeline(), "lost_layers": 0,
        }
        ch = self.chain()
        if self._cache is not None and self._tokens_seen is not None:
            # the rebuild runs outside the load lock: the refill thread
            # may keep loading meanwhile
            has_state = self._surviving_state()
            stats["lost_layers"] = int(sum(1 for h in has_state if not h))
            if not all(has_state):
                self._cache, stats["reconstruct"] = reconstruct_cache(
                    self.cfg, self._merged_params,
                    {"tokens": self._tokens_seen}, self._cache, has_state,
                    max_len=self.max_len)
            self._own_kv(ch)        # ownership follows the NEW chain
        if was_filling and not self.fully_loaded:
            self.start_fill(self._fill_interval_s, self._fill_budget)
        self._record_event("repartition", stats)
        return stats

    def recover(self) -> Dict[str, Any]:
        """Pipeline-parallel recovery: layer reassignment and, if
        mid-decode, KV/state reconstruction.  Returns a stats dict."""
        stats: Dict[str, Any] = {}
        with self._load_lock:
            alive = [d.idx for d in self.devices if d.alive]
            if not alive:
                raise EngineError("all devices dead")
            ch = self.chain()
            if ch is None:
                # survivors re-plan the missing spans (under the lock: a
                # fill round racing the plan swap would load the old plan)
                self.plan = reassign(self.plan, self.loaded_map(), alive)
                stats["replanned"] = True
        if stats.get("replanned"):
            while not self.ready:
                if not self.load_round():
                    raise EngineError("cannot complete chain")
            ch = self.chain()
        stats["chain"] = ch
        if self._cache is not None and self._tokens_seen is not None:
            has_state = self._surviving_state()
            self._cache, stats["reconstruct"] = reconstruct_cache(
                self.cfg, self._merged_params,
                {"tokens": self._tokens_seen}, self._cache, has_state,
                max_len=self.max_len)
            with self._load_lock:
                for dev, seg in ch:
                    self.devices[dev].kv_segments.add(seg)
        self._record_event("recover", stats)
        return stats


def generate(engine: PipeBoostEngine, batch: Dict, n_tokens: int,
             crash_at: Optional[int] = None,
             crash_devices: Sequence[int] = ()) -> torch.Tensor:
    """Greedy generation helper (tests, ``--crash-at``): returns (B,
    n_tokens); with ``crash_at``, ``crash_devices`` crash before that step
    and the engine recovers."""
    logits = engine.prefill(batch)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    outs = [tok]
    for i in range(1, n_tokens):
        if crash_at is not None and i == crash_at:
            engine.crash(crash_devices)
            engine.recover()
        tok = torch.argmax(engine.decode(tok), dim=-1).to(torch.int32)
        outs.append(tok)
    return torch.stack(outs, dim=1)
