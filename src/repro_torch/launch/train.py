"""Training launcher (the port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        [--steps N] [--batch B] [--seq S] [--reduced] [--layers L] \\
        [--ckpt-dir DIR] [--ckpt-every K] [--resume] [--accum K] \\
        [--grad-compression bf16] [--seed N] [--device cpu]

trains on one card (``--device cuda``, the default) in bf16 with every
layer rematerialised, at the architecture's full published width, on the
reference's ``SyntheticLM`` stream: AdamW with warmup over the first tenth
of the steps and cosine decay to the end.  ``--device cpu`` runs the
reduced config in float32 without remat, as the reference runs on its CPU
backend.  ``--layers`` cuts the depth at full width.  With ``--ckpt-dir``
the state and the data stream's position are saved every
``--ckpt-every`` steps (async) and at the end; ``--resume`` continues
from the newest checkpoint there.

One process drives one device: the sharding policy is installed over a
one-device host mesh (its metadata only: one token group for MoE
routing).  ``--production-mesh`` and ``--distributed-init`` need many
cards and exit with a message.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from repro_torch.configs.base import ARCH_IDS, get_arch
from repro_torch.distributed.context import ShardingPolicy, use_policy
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.training.checkpoint import Checkpointer
from repro_torch.training.data import SyntheticLM
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train import init_train_state, make_train_step


@dataclass
class TrainResult:
    arch: str
    n_params: int
    tokens_per_step: int
    start_step: int
    losses: List[float] = field(default_factory=list)   # one a step run
    step_s: List[float] = field(default_factory=list)   # wall, synced
    peak_memory_bytes: Optional[int] = None              # card only
    ckpt_save_s: Optional[float] = None                  # the final save
    ckpt_restore_s: Optional[float] = None               # --resume


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config (always on with --device cpu)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (full width)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "bf16"])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 16x16 mesh (needs 256 devices)")
    ap.add_argument("--distributed-init", action="store_true",
                    help="multi-host initialisation")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args) -> TrainResult:
    if args.production_mesh or args.distributed_init:
        raise SystemExit("--production-mesh and --distributed-init shard "
                         "the state across many cards; this launcher "
                         "trains on one")
    device = torch.device(args.device)
    on_cpu = device.type == "cpu"
    cfg = get_arch(args.arch)
    if args.reduced or on_cpu:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    dtype = torch.float32 if on_cpu else torch.bfloat16

    mesh = make_host_mesh(devices=[device])
    policy = ShardingPolicy(mesh, dp_axes=("data",), seq_axis="model")
    print(f"mesh: {mesh.shape}  arch: {cfg.name} "
          f"({cfg.param_count() / 1e6:.1f}M params)  device: {device}")

    opt = AdamWConfig(lr=1e-3, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = init_train_state(cfg, gen, dtype, device)
    step_fn = make_train_step(cfg, opt, remat=not on_cpu, accum=args.accum,
                              grad_compression=args.grad_compression)

    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                     batch_size=args.batch, seed=0)
    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    res = TrainResult(cfg.name, cfg.param_count(), args.batch * args.seq, 0)
    if ck and args.resume and ck.latest_step() is not None:
        t0 = time.perf_counter()
        state, extra = ck.restore(state)
        _sync(device)
        res.ckpt_restore_s = time.perf_counter() - t0
        ds.restore(extra["data"])
        start = res.start_step = extra["step"]
        print(f"resumed from step {start}")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_run = time.perf_counter()
    with use_policy(policy):
        for step in range(start, args.steps):
            b = {k: torch.from_numpy(v).to(device)
                 for k, v in ds.next_batch().items()}
            t0 = time.perf_counter()
            state, m = step_fn(state, b)
            res.losses.append(float(m["loss"]))       # syncs the step
            res.step_s.append(time.perf_counter() - t0)
            if (step + 1) % 10 == 0 or step + 1 == args.steps:
                dt = (time.perf_counter() - t_run) / (step + 1 - start)
                print(f"step {step + 1:5d} loss {res.losses[-1]:.4f} "
                      f"lr {float(m['lr']):.2e} "
                      f"gnorm {float(m['grad_norm']):.2f} "
                      f"({dt:.2f}s/step)")
            if ck and (step + 1) % args.ckpt_every == 0:
                ck.save(step + 1, state,
                        extra={"data": ds.state(), "step": step + 1},
                        async_=True)
    if device.type == "cuda":
        res.peak_memory_bytes = torch.cuda.max_memory_allocated(device)
    if ck:
        t0 = time.perf_counter()
        ck.save(args.steps, state,
                extra={"data": ds.state(), "step": args.steps})
        ck.wait()
        res.ckpt_save_s = time.perf_counter() - t0
    print("done")
    return res


def main(argv=None) -> TrainResult:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
