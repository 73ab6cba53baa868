"""Serving launcher: PipeBoost cold start -> continuous-batched serving with
merged-LoRA adapter epochs (the port of the single-server path of
``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch pipeboost-opt-1.3b --requests 8 --adapters 2
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch mamba2-780m --requests 8 --adapters 0
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-2b --requests 8 --adapters 0

runs on the card at the architecture's full published width, with random
weights made from ``--seed``.  ``--device cpu`` runs on the CPU with the
config reduced as the reference reduces it (depth 2 layers per device,
``ArchConfig.reduced``).

The run: a ``PipeBoostEngine`` over ``--devices`` logical devices becomes
ready after one loading round and fills the rest on a background thread;
a ``ServingEngine`` with ``EpochSchedulerPolicy`` serves the requests
(attention models: bucketed prefill through the flash-attention kernel,
zero-copy decode through the decode kernel; mamba2: each prompt prefilled
alone at its exact length through the SSD scan kernel, recurrent decode;
recurrentgemma: each prompt prefilled alone at its exact length through
the RG-LRU scan kernel and the flash kernel at head dim 256, decode
through the decode kernel and the elementwise recurrent step) with
``--adapters`` rank-16 adapters merged by the LoRA-merge kernel (an
attention-free model's adapters are empty and merge as the identity).
It prints ``cold_start_stats()``, the wall time to first token of each
request, decode throughput and the generated tokens.

``--crash-at N`` then injects the reference's single-server crash: the
engine prefills one more batch, device 1 crashes before decode step N,
``recover()`` rebuilds the lost layers' state on the survivors (printing
the reconstruct stats) and decoding continues.

Serverless cluster (router + autoscaler + cross-server crash re-routing,
the reference's ``run_cluster``):

    PYTHONPATH=src python -m repro_torch.launch.serve --cluster \
        --servers 2 --requests 16 --crash-at 3 [--wall-clock]

replays a ``burst_wave_trace`` (prompt lengths drawn from
``--prompt-len``) across ``--servers`` autoscaled PipeBoost servers of at
most 2 logical devices each, crashes server 1 after ``--crash-at``
completions (its in-flight requests migrate to survivors with their KV
snapshots) and rejoins it 20 ticks later, then prints TTFT/TBT
percentiles, queue depth, GPU-seconds and the event log.  On the card the
servers run at full width and share the base params and the merged
adapters; ``--device cpu`` runs the reduced config.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, ArchConfig, get_arch
from repro_torch.core.adapter_scheduler import EpochSchedulerPolicy
from repro_torch.core.engine import PipeBoostEngine, generate
from repro_torch.lora.adapters import init_lora, merge_lora, randomize_lora
from repro_torch.models import transformer as T
from repro_torch.serving.engine import ServeRequest, ServingEngine

LORA_RANK = 16
CLUSTER_MAX_DEVICES = 2      # logical devices per cluster server


@dataclass
class ServeResult:
    cfg: ArchConfig
    requests: List[ServeRequest]
    ttft_s: Dict[int, float]             # rid -> wall seconds to first token
    cold_start: Dict[str, object]
    hotpath: Dict[str, float]
    n_adapter_switches: int
    wall_s: float
    decode_tokens_per_s: float
    peak_memory_bytes: Optional[int]
    crash: Optional[Dict[str, object]] = None   # --crash-at's record


@dataclass
class ClusterResult:
    router: object                       # repro_torch.cluster.ClusterRouter
    scaler: object                       # its Autoscaler
    n_requests: int
    wall_s: float
    memory_before_spawn: Optional[int]   # card bytes allocated, else None
    memory_after_run: Optional[int]
    peak_memory_bytes: Optional[int]


def serving_config(arch: str, device: str, n_devices: int) -> ArchConfig:
    """The architecture at full width on the card; on the CPU reduced as
    the reference's launcher reduces it (>= 1 segment per device)."""
    cfg = get_arch(arch)
    if torch.device(device).type == "cpu":
        period = max(1, len(cfg.block_pattern) or 1)
        depth = ((2 * n_devices + period - 1) // period) * period
        cfg = cfg.reduced(n_layers=depth)
    return cfg


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args) -> ServeResult:
    device = torch.device(args.device)
    cfg = serving_config(args.arch, args.device, args.devices)
    if not cfg.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only; no serve loop")
    lo, hi = (int(x) for x in args.prompt_len.split("-"))
    if not 1 <= lo <= hi or hi + args.new_tokens > args.max_len:
        raise SystemExit(f"--prompt-len {args.prompt_len} plus "
                         f"--new-tokens {args.new_tokens} must fit "
                         f"--max-len {args.max_len}")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = T.init_params(cfg, gen, device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    # overlapped cold start: one loading round flips `ready` (each device
    # holds ~1/N of the model); the rest streams in on a background fill
    # thread while the serving engine admits and decodes
    eng = PipeBoostEngine(cfg, params, n_devices=args.devices,
                          max_len=args.max_len)
    t0 = time.perf_counter()
    eng.load_round()
    print(f"ready after 1 loading round ({time.perf_counter() - t0:.4f}s "
          f"wall): chain={eng.chain()}")
    eng.start_fill()

    adapter_params = merged_adapters(cfg, params, args.adapters, gen)

    srv = ServingEngine(cfg, params, n_slots=args.slots, max_len=args.max_len,
                        policy=EpochSchedulerPolicy(epoch_budget=4,
                                                    max_batch=args.slots),
                        adapter_params=adapter_params)
    rng = np.random.default_rng(args.seed)
    reqs = []
    for i in range(args.requests):
        adapter = (f"lora{i % args.adapters}" if args.adapters and i % 2
                   else None)
        plen = int(rng.integers(lo, hi + 1))
        reqs.append(ServeRequest(i, rng.integers(0, cfg.vocab_size,
                                                 size=plen),
                                 max_new_tokens=args.new_tokens,
                                 adapter=adapter))
    _sync(device)
    t_start = time.perf_counter()
    for r in reqs:
        srv.submit(r)
    ttft: Dict[int, float] = {}
    while True:
        srv.step()
        _sync(device)
        now = time.perf_counter() - t_start
        for r in reqs:
            if r.rid not in ttft and r.generated:
                ttft[r.rid] = now
        if srv.idle:
            break
    wall = time.perf_counter() - t_start
    eng.stop_fill()
    while eng.load_round():     # finish any tail the thread didn't reach
        pass
    cold = eng.cold_start_stats()
    hot = srv.hotpath_stats()
    crash = None
    if args.crash_at >= 0:
        crash = crash_and_recover(eng, cfg, rng, args, device)
    decode_tokens = sum(len(r.generated) - 1 for r in reqs)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    return ServeResult(cfg, reqs, ttft, cold, hot,
                       srv.n_adapter_switches, wall,
                       decode_tokens / hot["decode_time_s"]
                       if hot["decode_time_s"] > 0 else 0.0, peak, crash)


def merged_adapters(cfg: ArchConfig, params, n: int,
                    gen: torch.Generator) -> Dict[str, object]:
    """``n`` random rank-16 adapters merged into ``params`` (the LoRA-merge
    kernel on the card)."""
    out = {}
    for i in range(n):
        lora = randomize_lora(gen, init_lora(gen, cfg, rank=LORA_RANK,
                                             name=f"lora{i}",
                                             device=params["embed"].device))
        out[f"lora{i}"] = merge_lora(params, lora)
    return out


def run_cluster(args) -> ClusterResult:
    """Bursty trace -> router -> autoscaled PipeBoost servers; prints the
    TTFT/TBT percentile metrics the paper's cluster claims live on."""
    from repro_torch.cluster import (Autoscaler, AutoscalerConfig,
                                     ClusterConfig, ClusterRouter, WallClock,
                                     burst_wave_trace, make_dispatch)
    device = torch.device(args.device)
    n_dev = min(args.devices, CLUSTER_MAX_DEVICES)
    if n_dev != args.devices:
        print(f"capping --devices {args.devices} -> {n_dev} per server")
    cfg = serving_config(args.arch, args.device, n_dev)
    if not cfg.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only; no serve loop")
    lo, hi = (int(x) for x in args.prompt_len.split("-"))
    if not 1 <= lo <= hi or hi + args.new_tokens > args.max_len:
        raise SystemExit(f"--prompt-len {args.prompt_len} plus "
                         f"--new-tokens {args.new_tokens} must fit "
                         f"--max-len {args.max_len}")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = T.init_params(cfg, gen, device=device)
    adapter_params = merged_adapters(cfg, params, args.adapters, gen)
    trace = burst_wave_trace(args.requests, base_rate=2.0,
                             wave_rate=8.0 * max(args.servers, 1),
                             wave_at=0.5, wave_len=1.0, seed=args.seed,
                             max_new_tokens=args.new_tokens,
                             adapters=tuple(adapter_params))
    lens = np.random.default_rng(args.seed).integers(lo, hi + 1,
                                                     size=len(trace))
    trace = [dataclasses.replace(a, prompt_len=int(n))
             for a, n in zip(trace, lens)]
    ccfg = ClusterConfig(n_devices=n_dev, n_slots=args.slots,
                         max_len=args.max_len)
    scaler = Autoscaler(AutoscalerConfig(target_queue_per_server=args.slots,
                                         max_servers=args.max_servers,
                                         ttft_slo_s=1.0))
    _sync(device)
    mem0 = (torch.cuda.memory_allocated(device)
            if device.type == "cuda" else None)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    # the same router/scheduler code runs logical ticks (default,
    # deterministic) or wall time (--wall-clock): the clock is injected
    router = ClusterRouter(cfg, params, n_servers=args.servers, ccfg=ccfg,
                           autoscaler=scaler, adapter_params=adapter_params,
                           dispatch=make_dispatch(args.dispatch),
                           clock=WallClock() if args.wall_clock else None)
    t0 = time.perf_counter()
    crash = args.crash_at if args.crash_at >= 0 else None
    router.run(trace, crash_after_completions=crash,
               crash_server_id=min(1, args.servers - 1),
               rejoin_after_ticks=20 if crash is not None else None,
               engine=args.engine)
    _sync(device)
    wall = time.perf_counter() - t0
    mem1 = peak = None
    if device.type == "cuda":
        mem1 = torch.cuda.memory_allocated(device)
        peak = torch.cuda.max_memory_allocated(device)
    return ClusterResult(router, scaler, len(trace), wall, mem0, mem1, peak)


def report_cluster(res: ClusterResult, metrics_json: str = "") -> None:
    router, scaler = res.router, res.scaler
    s = router.metrics.summary()
    cfg = router.cfg
    print(f"cluster: {int(s['n_completed'])}/{res.n_requests} requests "
          f"completed ({res.wall_s:.1f}s wall, {int(s['servers_max'])} "
          f"servers peak, {scaler.n_scale_ups} scale-ups, "
          f"{int(s['n_rerouted'])} crash-rerouted; {cfg.name}, "
          f"{cfg.n_layers} layers, d_model {cfg.d_model})")
    print(f"  TTFT  p50={s['ttft_p50']:.3f}s  p99={s['ttft_p99']:.3f}s  "
          f"mean={s['ttft_mean']:.3f}s")
    print(f"  TBT   p50={s['tbt_p50']:.3f}s  p99={s['tbt_p99']:.3f}s  "
          f"mean={s['tbt_mean']:.3f}s")
    print(f"  queue_depth_max={int(s['queue_depth_max'])}  "
          f"gpu_seconds={s['gpu_seconds']:.1f}  "
          f"throughput={s['throughput_tok_s']:.1f}tok/s")
    if res.peak_memory_bytes is not None:
        print(f"  device memory: {res.memory_before_spawn} B before the "
              f"first spawn, {res.memory_after_run} B after the run, "
              f"peak {res.peak_memory_bytes} B")
    for t, kind, detail in router.metrics.events:
        print(f"  [t={t:6.2f}] {kind:9s} {detail}")
    if metrics_json:
        router.metrics.to_json(metrics_json)
        print(f"  metrics written to {metrics_json}")
    if int(s["n_completed"]) != res.n_requests:
        raise SystemExit("cluster run did not complete all requests")


def crash_and_recover(eng: PipeBoostEngine, cfg: ArchConfig, rng, args,
                      device: torch.device) -> Dict[str, object]:
    """The reference's single-server crash injection: prefill one batch on
    the engine, crash device 1 before decode step ``--crash-at``, recover
    on the survivors and decode on to ``--new-tokens`` tokens."""
    print(f"injecting crash on device 1 of the PipeBoost engine at decode "
          f"step {args.crash_at}...")
    lost = eng.lost_state_layers([1])
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(1, 8))).to(device)}
    tokens = generate(eng, batch, args.new_tokens, crash_at=args.crash_at,
                      crash_devices=[1])
    stats = [p for e, p in eng.events if e == "recover"][-1]
    print(f"  layers whose state device 1 held: "
          f"{[i for i, x in enumerate(lost) if x]}")
    print(f"  recovered: {stats.get('reconstruct')}")
    print(f"  decode continued through the crash: "
          f"{tokens[0].tolist()}")
    return {"lost_layers": lost, "recover": stats, "tokens": tokens}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="pipeboost-opt-1.3b")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the reduced config")
    ap.add_argument("--devices", type=int, default=4,
                    help="logical devices of the PipeBoost engine")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--prompt-len", default="64-512",
                    help="prompt lengths drawn uniformly from LO-HI")
    ap.add_argument("--max-len", type=int, default=1024)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--adapters", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--crash-at", type=int, default=-1,
                    help="single server: after serving, crash device 1 of "
                         "the engine at this decode step of a new batch and "
                         "recover; --cluster: crash server 1 after this "
                         "many completions (re-route + rejoin)")
    ap.add_argument("--cluster", action="store_true",
                    help="serverless cluster mode: bursty trace across "
                         "--servers autoscaled PipeBoost servers")
    ap.add_argument("--servers", type=int, default=2)
    ap.add_argument("--max-servers", type=int, default=8)
    ap.add_argument("--dispatch", default="least_loaded",
                    choices=("least_loaded", "slo_aware", "adapter_affine"),
                    help="--cluster: dispatch policy (cluster/scheduler.py)")
    ap.add_argument("--wall-clock", action="store_true",
                    help="--cluster: run the router off time.monotonic "
                         "instead of logical ticks")
    ap.add_argument("--engine", default="event", choices=("event", "tick"),
                    help="--cluster: replay loop; 'event' jumps the clock "
                         "across quiescent gaps, 'tick' polls every tick "
                         "(the equivalence oracle)")
    ap.add_argument("--metrics-json", default="",
                    help="--cluster: also dump ClusterMetrics JSON here")
    return ap


def main(argv=None):
    """Run the launcher; returns a ``ServeResult``, or a ``ClusterResult``
    with ``--cluster``."""
    args = parser().parse_args(argv)
    if args.cluster:
        res = run_cluster(args)
        report_cluster(res, args.metrics_json)
        return res
    res = run(args)
    cs = res.cold_start
    overlapped = cs["time_to_fully_loaded"] is None \
        or cs["time_to_fully_loaded"] > cs["time_to_ready"]
    print(f"served {len(res.requests)} requests of {res.cfg.name} "
          f"({res.cfg.n_layers} layers, d_model {res.cfg.d_model}; "
          f"{res.n_adapter_switches} adapter switches) in {res.wall_s:.3f}s")
    print(f"  cold start: {cs}  (serving overlapped loading={overlapped})")
    print(f"  decode: {res.decode_tokens_per_s:.1f} tokens/s over "
          f"{int(res.hotpath['n_decode_steps'])} steps; "
          f"{int(res.hotpath['n_prefill_calls'])} prefill calls")
    if res.peak_memory_bytes is not None:
        print(f"  peak device memory: {res.peak_memory_bytes} B")
    for r in res.requests:
        print(f"  req{r.rid} adapter={r.adapter or 'base':6s} "
              f"prompt={len(r.tokens)} ttft={res.ttft_s[r.rid]:.4f}s "
              f"-> {r.generated}")
    return res


if __name__ == "__main__":
    main()
