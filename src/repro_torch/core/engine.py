"""PipeBoost engine: pipeline-parallel loading over logical devices, with
inference once a viable chain exists and the strategy switch (the port of
``repro/core/engine.py``, paper §4.1–§4.3).

As in the reference, the devices are bookkeeping entities: loading records
which segment each device holds (``engine.py:142-153`` of the reference)
while the whole model is already resident on the one card, and
inference runs the full model.  The engine owns correctness: a request
served before full load produces exactly the tokens of a fully loaded
model.

Not ported yet (see ROADMAP.md): crash/recover/restart/revive/repartition,
peer multicast loads, KV reconstruction and the pipeline prefill.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Set, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import analytic
from repro_torch.core.planner import LoadPlan, make_plan, viable_chain
from repro_torch.lora.adapters import LoRAAdapter, merge_lora
from repro_torch.models import transformer


class EngineError(RuntimeError):
    pass


@dataclass
class DeviceState:
    idx: int
    alive: bool = True
    loaded: Set[int] = field(default_factory=set)      # fully-loaded segments


@dataclass
class LoadRound:
    """Accounting for one background-fill round (overlapped cold start)."""
    idx: int
    t_start: float                       # seconds since engine construction
    wall_s: float                        # wall-clock spent inside the round
    bytes: int                           # segment bytes transferred this round
    segments: List[Tuple[int, int]]      # (device, segment) loads


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
                 max_len: int = 256,
                 adapters: Optional[Dict[str, LoRAAdapter]] = None):
        self.cfg = cfg
        self._full_params = params          # "checkpoint in DRAM"
        self.n_devices = n_devices
        self.plan: LoadPlan = make_plan(analytic.layer_bytes_list(cfg),
                                        n_devices)
        self.devices = [DeviceState(i) for i in range(n_devices)]
        self.max_len = max_len
        self.strategy = "pipeline"          # -> "single" after switch
        self.adapters = adapters or {}
        self.active_adapter: Optional[str] = None
        self._merged_params = params        # params w/ active adapter merged
        self._cache: Optional[Dict] = None
        self.events: List[Tuple[str, Any]] = []
        # loading is re-entrant (background thread or generator-stepped)
        # and accounted per round
        self._load_lock = threading.RLock()
        self._fill_thread: Optional[threading.Thread] = None
        self._fill_stop = threading.Event()
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

    def load_round(self) -> Optional[LoadRound]:
        """One loading round across alive devices: each loads its next
        segment.  Safe to call from a background thread while serving.
        Returns the round's accounting, or None when nothing was left to
        load."""
        t0 = time.perf_counter()
        loads: List[Tuple[int, int]] = []
        round_: Optional[LoadRound] = None
        with self._load_lock:
            for d in self.devices:
                if d.alive:
                    s = self.load_next_segment(d.idx)
                    if s is not None:
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

    def fill_steps(self) -> Iterator[LoadRound]:
        """Generator-step fill: yields one ``LoadRound`` per round until
        the model is fully loaded."""
        while True:
            round_ = self.load_round()
            if round_ is None:
                return
            yield round_

    def start_fill(self, interval_s: float = 0.0) -> threading.Thread:
        """Start the background fill: a daemon thread runs ``load_round``
        until fully loaded (or ``stop_fill``), overlapping serving on the
        main thread."""
        if self._fill_thread is not None and self._fill_thread.is_alive():
            return self._fill_thread
        self._fill_stop.clear()

        def _run():
            while not self._fill_stop.is_set():
                if not self.load_round():
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

    def rounds_to_ready(self) -> int:
        """Predicted ``load_round`` calls until a viable chain exists (0
        when ready); simulated on copies of the loaded sets.  A large
        sentinel when no amount of loading completes a chain."""
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
                            if s not in loaded[i]][:1]
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

    def prefill(self, batch: Dict) -> torch.Tensor:
        """Serve a prefill the moment a chain exists (after each device
        loaded only ~1/N of the model)."""
        chain = self.chain()
        if chain is None:
            raise EngineError("no viable pipeline chain: model not ready")
        logits, self._cache = transformer.forward(
            self.cfg, self._merged_params, batch, mode="prefill",
            max_len=self.max_len)
        with self._load_lock:
            self.events.append(("prefill", chain))
            self.events.append(("prefill_backend", "single"))
        return logits

    def decode(self, tokens: torch.Tensor) -> torch.Tensor:
        if self._cache is None:
            raise EngineError("prefill first")
        if self.strategy == "pipeline" and self.chain() is None:
            raise EngineError("pipeline chain broken")
        logits, self._cache = transformer.decode_step(
            self.cfg, self._merged_params, {"tokens": tokens}, self._cache)
        return logits

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
