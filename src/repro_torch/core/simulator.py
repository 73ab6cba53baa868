"""Deterministic event-driven cold-start / recovery simulator (DESIGN.md §2).

The paper's latency results are functions of byte flows over a small set of
hardware channels (SSD→DRAM, DRAM→device, inter-device hops) plus compute.
This module models those channels explicitly so every paper experiment
(Figs. 8–17, Table 1) is reproducible as a deterministic computation — and
so the same planner code that drives the real engine is what gets timed.

Two hardware presets:
  * ``GPU_PAPER``  — calibrated to the paper's A100 testbed (Table 1).
  * ``TPU_V5E``    — the repo's TPU target (197 TF bf16, 819 GB/s HBM,
                     ~50 GB/s/link ICI), used for the beyond-paper analysis.

See ``docs/ARCHITECTURE.md`` § "Core: the PipeBoost engine".

The port's own copy of ``repro/core/simulator.py``
(plain Python and numpy: the port imports nothing of the JAX package).
The ``HwModel`` constants are the paper's modelled hardware, not
measurements of the card the port runs on.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.core import analytic
from repro_torch.core.planner import (LoadPlan, critical_path_bytes, make_plan,
                                      reassign, viable_chain)


@dataclass(frozen=True)
class HwModel:
    name: str = "gpu-paper"
    ssd_bw: float = 13e9        # effective ckpt->DRAM stream (page-cache assisted)
    host_link_bw: float = 4.2e9 # effective DRAM->device per device
    host_agg_bw: float = 60e9   # aggregate DRAM read bandwidth cap
    transfer_fixed_s: float = 0.08  # per-device transfer setup cost
    init_meta_s: float = 0.26   # full-model metadata init (scales with share)
    chip_flops: float = 312e12  # peak (A100 fp16)
    mfu: float = 0.30           # achieved fraction during prefill
    hbm_bw: float = 1.6e12
    ici_bw: float = 25e9        # inter-device (NVLink/PCIe P2P or ICI)
    hop_latency: float = 100e-6 # per pipeline hop (kernel launch + sync)
    lora_merge_bw: float = 0.5e12  # bytes/s of W touched during merged-LoRA


GPU_PAPER = HwModel()
TPU_V5E = HwModel(name="tpu-v5e", ssd_bw=13e9, host_link_bw=8e9,
                  host_agg_bw=120e9, transfer_fixed_s=0.03,
                  init_meta_s=0.12, chip_flops=197e12, mfu=0.45,
                  hbm_bw=819e9, ici_bw=50e9, hop_latency=20e-6,
                  lora_merge_bw=0.4e12)


# ---------------------------------------------------------------------------
# Shared timing primitives
# ---------------------------------------------------------------------------

def host_bw_effective(hw: HwModel, concurrent: int) -> float:
    """Per-stream host (DRAM->device) bandwidth with ``concurrent``
    simultaneous pulls sharing the aggregate read path.

    Each stream gets at most its own link (``host_link_bw``), and the sum
    of all streams is capped by ``host_agg_bw`` — so N simultaneous
    host-only cold starts contend for the aggregate instead of each
    filling at full link rate.  This is the cost model the cluster's
    multicast scale-out (``cluster/multicast.py``) and the host-only
    bench baseline price host fills through.
    """
    return min(hw.host_link_bw, hw.host_agg_bw / max(1, concurrent))


def _link_bw(hw: HwModel, concurrent: int) -> float:
    """Backwards-compatible alias of :func:`host_bw_effective` (the
    pre-PR-9 private name, kept for in-module callers)."""
    return host_bw_effective(hw, concurrent)


def prefill_time(cfg: ArchConfig, hw: HwModel, batch: int, prompt: int,
                 n_stages: int = 1) -> float:
    f = analytic.forward_flops(cfg, batch, prompt)
    t = f / (hw.chip_flops * hw.mfu)
    if n_stages > 1:
        # one request's prefill traverses all stages sequentially; per-stage
        # compute is f/n but the total is still ~f (+ hop overheads + one
        # hidden-state transfer per boundary)
        hid = batch * prompt * cfg.d_model * 2  # bf16 hidden state
        t = t + (n_stages - 1) * (hw.hop_latency + hid / hw.ici_bw)
    return t


def decode_step_time(cfg: ArchConfig, hw: HwModel, batch: int, kv_len: int,
                     n_stages: int = 1) -> float:
    f = analytic.forward_flops(cfg, batch, 1, kv_len=kv_len)
    b = analytic.decode_step_bytes(cfg, batch, kv_len)
    t = max(f / (hw.chip_flops * hw.mfu), b / hw.hbm_bw) / n_stages
    if n_stages > 1:
        hid = batch * cfg.d_model * 2
        t += hw.hop_latency + hid / hw.ici_bw
    return t


# ---------------------------------------------------------------------------
# Snapshot migration cost (bytes over a link)
# ---------------------------------------------------------------------------
# Crash migration moves a KVSnapshot's rows between servers.  The byte
# count is architecture-determined; which link it crosses depends on the
# deployment (same host: device->device over NVLink/ICI; cross host:
# device->DRAM->NIC, bounded by the PCIe/host link).  GPU_PAPER carries
# both bandwidths: ``ici_bw`` (NVLink-class P2P) and ``host_link_bw``
# (PCIe-class DRAM<->device).

SNAPSHOT_LINKS = ("nvlink", "pcie")


def kv_snapshot_bytes(cfg: ArchConfig, pos: int, max_len: int,
                      dtype_bytes: int = 2) -> int:
    """Modeled wire size of one request's ``KVSnapshot`` at ``pos`` tokens.

    Attention layers: K+V rows for the cached window
    (``min(pos, capacity)`` positions x n_kv_heads x head_dim, 2 tensors).
    SSM (mamba-style) layers: the recurrent state (heads x head_dim x
    d_state) + conv buffer — position-independent.  RG-LRU layers: the
    hidden state.  This is the *payload* a migration must move; the
    repo's in-memory snapshots carry full ``max_len`` rows (pre-sliced
    layout), so the model is the honest lower bound a wire format would
    ship.
    """
    # windowed attention rings hold at most attn_window rows (the same
    # capacity rule as transformer.attn_cache_capacity)
    capacity = min(max_len, cfg.attn_window) if cfg.attn_window > 0 \
        else max_len
    kv_len = min(pos, capacity)
    hd = cfg.resolved_head_dim
    total = 0
    for kind in cfg.layer_kinds():
        if kind in ("attn", "moe"):
            total += 2 * kv_len * cfg.n_kv_heads * hd * dtype_bytes
        elif kind == "ssm":
            # SSD state (H, P, N) + conv ring buffer
            total += (cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state
                      + cfg.d_inner * cfg.ssm_conv) * dtype_bytes
        else:  # rec (RG-LRU): hidden state at the recurrence width
            total += (cfg.lru_width or cfg.d_model) * dtype_bytes
    return total


def snapshot_transfer_time(nbytes: int, hw: HwModel,
                           link: str = "nvlink") -> float:
    """Seconds to move ``nbytes`` of snapshot state over ``link``
    ("nvlink" = device-P2P ``ici_bw``, "pcie" = ``host_link_bw``), plus
    one hop latency.  ``bench_recovery`` reports this modeled time next
    to the measured post-crash TTFT so the functional CPU numbers carry a
    paper-testbed interpretation."""
    if link == "nvlink":
        bw = hw.ici_bw
    elif link == "pcie":
        bw = hw.host_link_bw
    else:
        raise ValueError(f"unknown link {link!r}; "
                         f"available: {SNAPSHOT_LINKS}")
    return hw.hop_latency + nbytes / bw


def state_resurrect_time(nbytes: int, hw: HwModel,
                         concurrent: int = 1) -> float:
    """Seconds to pull a spilled state-tier bundle (prefix-cache rows +
    KV snapshots) from host DRAM back onto a freshly spawned server.

    The bundle streams over the DRAM->device path, so with ``concurrent``
    simultaneous pulls (several servers resurrecting, or a resurrect
    overlapping host cold-start fills) each stream shares the aggregate
    via :func:`host_bw_effective` — the same contention model multicast
    prices host fills through — plus one per-device transfer setup cost.
    The cluster router prices spill/resurrect decisions with this
    (``docs/ARCHITECTURE.md`` § "Fleet state tier")."""
    return hw.transfer_fixed_s + nbytes / host_bw_effective(hw, concurrent)


# ---------------------------------------------------------------------------
# Cold start
# ---------------------------------------------------------------------------

@dataclass
class ColdStartResult:
    strategy: str
    ttft: float
    t_ready: float              # inference service ready (chain complete)
    t_full: float               # every device holds the full model
    breakdown: Dict[str, float]
    timeline: List[Tuple[float, str]] = field(default_factory=list)


def simulate_cold_start(cfg: ArchConfig, hw: HwModel, n_devices: int,
                        strategy: str, *, batch: int = 64, prompt: int = 64,
                        lora_rank: int = 0, n_adapters: int = 1,
                        ckpt_in_dram: bool = False,
                        dtype_bytes: int = 2) -> ColdStartResult:
    """TTFT of one cold start under a given loading strategy.

    strategies: 'transformers' | 'serverlessllm' | 'pipeboost'.
    """
    Wb = analytic.param_bytes(cfg, dtype_bytes)
    lora_frac = 0.0
    if lora_rank:
        # adapters on q,k,v,o of every attn layer
        hd = cfg.resolved_head_dim
        per_layer = lora_rank * (3 * cfg.d_model + hd * (cfg.n_heads + 2 * cfg.n_kv_heads)
                                 + cfg.n_heads * hd + cfg.d_model)
        n_attn = sum(1 for k in cfg.layer_kinds() if k in ("attn", "moe"))
        lora_b = per_layer * n_attn * dtype_bytes * n_adapters
        lora_frac = lora_b / Wb
    timeline: List[Tuple[float, str]] = []
    bd: Dict[str, float] = {}

    t_ckpt = 0.0 if ckpt_in_dram else Wb / hw.ssd_bw
    bd["load_ckpt_dram"] = t_ckpt
    bd["load_lora_dram"] = t_ckpt * lora_frac
    timeline.append((t_ckpt, "ckpt_in_dram"))

    if strategy == "transformers":
        # CPU-side deserialize (single stream), then every device pulls the
        # full parameter set concurrently.
        t_init = hw.init_meta_s * 2.0  # transformers-style init is heavier
        bw = _link_bw(hw, n_devices)
        t_xfer = hw.transfer_fixed_s + Wb * (1 + lora_frac) / bw
        t_ready = t_ckpt * (1 + lora_frac) + t_init + t_xfer
        t_full = t_ready
        bd["init_meta"] = t_init
        bd["load_params"] = t_xfer
        t_prefill = prefill_time(cfg, hw, batch, prompt, n_stages=1)
    elif strategy == "serverlessllm":
        t_init = hw.init_meta_s
        bw = _link_bw(hw, n_devices)
        t_xfer = hw.transfer_fixed_s + Wb * (1 + lora_frac) / bw
        t_ready = t_ckpt * (1 + lora_frac) + t_init + t_xfer
        t_full = t_ready
        bd["init_meta"] = t_init
        bd["load_params"] = t_xfer
        t_prefill = prefill_time(cfg, hw, batch, prompt, n_stages=1)
    elif strategy == "pipeboost":
        # each device transfers only its serve-span on the critical path
        t_init = hw.init_meta_s / n_devices + 0.02
        bw = _link_bw(hw, n_devices)
        span = Wb / n_devices
        t_xfer = hw.transfer_fixed_s + span * (1 + lora_frac) / bw
        t_ready = t_ckpt * (1 + lora_frac) + t_init + t_xfer
        # background fill of the remaining (N-1)/N while serving
        t_full = t_ready + (Wb - span) / bw
        bd["init_meta"] = t_init
        bd["load_params"] = t_xfer
        t_prefill = prefill_time(cfg, hw, batch, prompt, n_stages=n_devices)
    else:
        raise ValueError(strategy)

    if lora_rank:
        # merged-LoRA: one pass over the device-resident span of W
        span = Wb / (n_devices if strategy == "pipeboost" else 1)
        t_merge = span / hw.lora_merge_bw
        bd["lora_merge"] = t_merge
        t_ready += t_merge
        t_full += t_merge
    bd["prefill"] = t_prefill
    ttft = t_ready + t_prefill
    bd["total"] = ttft
    timeline.append((t_ready, "service_ready"))
    timeline.append((ttft, "first_token"))
    timeline.append((t_full, "fully_loaded"))
    return ColdStartResult(strategy, ttft, t_ready, t_full, bd, timeline)


# ---------------------------------------------------------------------------
# Recovery during loading (paper Fig. 15/16)
# ---------------------------------------------------------------------------

@dataclass
class RecoveryResult:
    mode: str
    recovery_time: float   # crash -> service resumes
    ttft: float            # request arrival (t=0) -> first token
    detail: Dict[str, float] = field(default_factory=dict)


def simulate_loading_failure(cfg: ArchConfig, hw: HwModel, n_devices: int,
                             failed: Sequence[int], fail_frac: float = 0.5,
                             mode: str = "pp", *, batch: int = 64,
                             prompt: int = 64,
                             dtype_bytes: int = 2) -> RecoveryResult:
    """Crash ``failed`` devices when each device has loaded ``fail_frac`` of
    its first segment; measure time until the (re-planned) chain is ready.

    mode='pp'   — paper's Pipeline-Parallel Recovery (planner.reassign)
    mode='full' — restart pipeline-parallel loading from scratch on survivors
    """
    Wb = analytic.param_bytes(cfg, dtype_bytes)
    lb = analytic.layer_bytes_list(cfg, dtype_bytes)
    plan = make_plan(lb, n_devices)
    seg_b = [s.bytes for s in plan.segments]
    bw = _link_bw(hw, n_devices)
    survivors = [d for d in range(n_devices) if d not in set(failed)]
    bw_after = _link_bw(hw, len(survivors))

    t_ckpt = Wb / hw.ssd_bw
    t_init = hw.init_meta_s / n_devices + 0.02
    # crash instant: each device mid-way through its first segment
    t_crash = t_ckpt + t_init + hw.transfer_fixed_s + \
        fail_frac * (Wb / n_devices) / bw

    loaded = {d: [] for d in range(n_devices)}  # fully-loaded segments only
    if mode == "pp":
        new_plan = reassign(plan, loaded, survivors)
        # each survivor finishes its current segment then loads its new span
        rem = {}
        for d in survivors:
            first = plan.order[d][0]
            need = (1 - fail_frac) * seg_b[first]
            for s in new_plan.serve_assignment[d]:
                if s != first:
                    need += seg_b[s]
            rem[d] = need
        t_load = max(rem.values()) / bw_after
        t_resume = t_crash + t_load
    elif mode == "full":
        # tear down and restart: re-init + transfer full span per survivor
        new_plan = make_plan(lb, len(survivors))
        cp = critical_path_bytes(new_plan)
        t_load = hw.transfer_fixed_s + max(cp.values()) / bw_after
        # complete restart: full framework/metadata re-init, not 1/N
        t_resume = t_crash + hw.init_meta_s + 0.02 + t_load
    else:
        raise ValueError(mode)

    t_prefill = prefill_time(cfg, hw, batch, prompt, n_stages=len(survivors))
    return RecoveryResult(mode, t_resume - t_crash, t_resume + t_prefill,
                          {"t_crash": t_crash, "t_resume": t_resume,
                           "prefill": t_prefill})


# ---------------------------------------------------------------------------
# Recovery during inference (paper Fig. 17)
# ---------------------------------------------------------------------------

def simulate_inference_failure(cfg: ArchConfig, hw: HwModel, n_devices: int,
                               *, fail_at: float = 6.0, horizon: float = 16.0,
                               batch: int = 8, prompt: int = 64,
                               kv_len: int = 256, mode: str = "pp",
                               dt: float = 0.25,
                               dtype_bytes: int = 2) -> List[Tuple[float, float]]:
    """Tokens/s timeline with one device crash at ``fail_at`` seconds.

    mode='pp':  re-plan to a shorter chain + KV-reconstruction stall for the
                layers whose KV lived on the dead device.
    mode='full': full reload of the model on survivors (service halt).
    """
    step_n = decode_step_time(cfg, hw, batch, kv_len, n_stages=n_devices)
    thr_n = batch / step_n
    survivors = n_devices - 1
    step_s = decode_step_time(cfg, hw, batch, kv_len, n_stages=survivors)
    thr_s = batch / step_s

    Wb = analytic.param_bytes(cfg, dtype_bytes)
    bw = _link_bw(hw, survivors)
    if mode == "pp":
        # survivors already hold most layers (background fill had progressed);
        # stall = load the dead device's span + rebuild its layers' KV
        t_load = (Wb / n_devices) / bw
        miss_frac = 1.0 / n_devices
        t_kv = prefill_time(cfg, hw, batch, prompt + kv_len) * miss_frac
        stall = t_load * 0.35 + t_kv  # span mostly pre-filled in background
    else:
        stall = hw.transfer_fixed_s + hw.init_meta_s / survivors + \
            (Wb / survivors) / bw + prefill_time(cfg, hw, batch,
                                                 prompt + kv_len)
    out = []
    t = 0.0
    while t < horizon:
        if t < fail_at:
            thr = thr_n
        elif t < fail_at + stall:
            thr = 0.0 if mode == "full" else thr_s * 0.5
        else:
            thr = thr_s
        out.append((round(t, 6), thr))
        t += dt
    return out


# ---------------------------------------------------------------------------
# Strategy crossover (paper Fig. 6): pipeline vs per-device inference
# ---------------------------------------------------------------------------

def simulate_request_latency(cfg: ArchConfig, hw: HwModel, n_devices: int,
                             rps: float, *, strategy: str = "pipeline",
                             batch: int = 1, prompt: int = 64,
                             gen_tokens: int = 32, horizon: float = 30.0,
                             seed: int = 0) -> Dict[str, float]:
    """Mean/var of request completion latency under Poisson-ish arrivals.

    'pipeline': all requests flow through one N-stage pipeline (hop overhead
                per stage per step); 'single': requests round-robin over N
                independent replicas.
    """
    rng = _lcg(seed)
    arrivals = []
    t = 0.0
    while t < horizon:
        t += -math.log(max(rng(), 1e-12)) / max(rps, 1e-9)
        arrivals.append(t)
    # per-request compute is the same either way; the pipeline pays an
    # inter-stage hop (latency + hidden-state transfer) per token per
    # boundary — the communication overhead the paper's Fig. 6 blames.
    svc_compute = prefill_time(cfg, hw, batch, prompt) + \
        gen_tokens * decode_step_time(cfg, hw, batch, prompt)
    if strategy == "pipeline":
        hid = batch * cfg.d_model * 2
        hop = hw.hop_latency + hid / hw.ici_bw
        svc = svc_compute + (gen_tokens + 1) * (n_devices - 1) * hop
        servers = [0.0]
        admit_interval = svc / n_devices   # belt: n_devices mbs in flight
    else:
        svc = svc_compute
        servers = [0.0] * n_devices
        admit_interval = svc
    lat: List[float] = []
    for i, a in enumerate(arrivals):
        s = i % len(servers)
        start = max(a, servers[s])
        servers[s] = start + admit_interval
        lat.append(start + svc - a)
    mean = sum(lat) / len(lat)
    var = sum((x - mean) ** 2 for x in lat) / len(lat)
    return {"mean": mean, "var": var, "p50": sorted(lat)[len(lat) // 2],
            "n": float(len(lat))}


def _lcg(seed: int):
    state = [seed * 6364136223846793005 + 1442695040888963407]

    def nxt() -> float:
        state[0] = (state[0] * 6364136223846793005 + 1442695040888963407) % 2**64
        return (state[0] >> 11) / float(2**53)
    return nxt
