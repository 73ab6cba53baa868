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

One process alone drives one device: the sharding policy is installed
over a one-device host mesh (its metadata only: one token group for MoE
routing), and the state is plain tensors.

Across devices, one process a device, under ``torchrun`` (``WORLD_SIZE``
set) or with ``--distributed-init`` (the reference's
``jax.distributed.initialize()``)::

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu
    torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
        --arch pipeboost-opt-1.3b --distributed-init

joins the process group (``nccl`` over the cards, ``gloo`` for
``--device cpu``) and trains over the host mesh ``(world, 1)`` ('data',
'model'), or with ``--production-mesh`` the 16 x 16 mesh over exactly
256 ranks.  The whole train state (the parameters and AdamW's m and v,
ZeRO) is sharded FSDP by ``param_specs(..., mode="fsdp")`` as DTensors,
every batch by ``batch_specs``; the kernels run on each rank's rows
(``kernels/ops.py``).  Every rank draws the same weights from the same
seed and keeps its shards; every rank of a node reads the node's batch
from ``SyntheticLM`` at the node's index among the nodes (the reference's
``jax.process_index()``/``process_count()``: hosts, not devices) and
keeps its rows.  Checkpoints are saved whole from rank 0 and restore onto
any mesh.  Rank 0 alone prints.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ARCH_IDS, get_arch
from repro_torch.distributed import shardings as shd
from repro_torch.distributed.context import ShardingPolicy, use_policy
from repro_torch.launch.mesh import (DistInfo, init_distributed,
                                     make_host_mesh, make_production_mesh)
from repro_torch.training.checkpoint import Checkpointer
from repro_torch.training.data import SyntheticLM
from repro_torch.models.transformer import init_params
from repro_torch.training.optimizer import (AdamWConfig, init_opt_state,
                                            tree_leaves)
from repro_torch.training.train import TrainState, make_train_step


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
    state_bytes: int = 0          # the train state's tensors on this
                                  # device (a step's donated input, as the
                                  # dry run counts)
    world: int = 1                # ranks of the process group
    mesh: Dict[str, int] = field(default_factory=dict)


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
                    help="the 16x16 mesh (needs 256 ranks)")
    ap.add_argument("--distributed-init", action="store_true",
                    help="join torchrun's process group (multi-host)")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _process_group(args) -> Optional[DistInfo]:
    """This process's place in torchrun's process group, or None for a
    process alone (no ``WORLD_SIZE``, no ``--distributed-init``)."""
    if "WORLD_SIZE" not in os.environ and not args.distributed_init:
        return None
    try:
        return init_distributed(device_type=torch.device(args.device).type)
    except RuntimeError as e:
        raise SystemExit(f"--distributed-init: {e} (start the launcher "
                         f"under torchrun)")


def _local_bytes(t: torch.Tensor) -> int:
    if type(t).__name__ == "DTensor":
        t = t.to_local()
    return t.numel() * t.element_size()


def run(args) -> TrainResult:
    owned = not dist.is_initialized()
    info = _process_group(args)
    try:
        return _train(args, info)
    finally:
        if info and owned:
            dist.destroy_process_group()


def _train(args, info: Optional[DistInfo]) -> TrainResult:
    world = info.world if info else 1
    device = info.device if info else torch.device(args.device)
    on_cpu = device.type == "cpu"
    lead = info is None or info.rank == 0
    say = print if lead else (lambda *a, **k: None)
    cfg = get_arch(args.arch)
    if args.reduced or on_cpu:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    dtype = torch.float32 if on_cpu else torch.bfloat16

    if args.production_mesh:
        mesh = make_production_mesh()
        if world != mesh.size:
            raise SystemExit(f"--production-mesh builds the 16 x 16 mesh "
                             f"over {mesh.size} ranks; the world is "
                             f"{world}")
        mesh = dataclasses.replace(mesh, devices=(device,) * mesh.size)
    elif info:
        mesh = make_host_mesh()
    else:
        mesh = make_host_mesh(devices=[device])
    policy = ShardingPolicy(mesh, dp_axes=("data",), seq_axis="model")
    say(f"mesh: {mesh.shape}  arch: {cfg.name} "
        f"({cfg.param_count() / 1e6:.1f}M params)  device: {device}"
        + (f"  world: {world} ({info.backend})" if info else ""))

    opt = AdamWConfig(lr=1e-3, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, dtype, device)
    shard_batch = None
    if info:
        # every rank draws the same whole weights from the same seed and
        # keeps its shards; AdamW's moments are then made as shards
        shd.register_strategies()
        params = shd.distribute(
            params, shd.param_specs(cfg, params, mesh, mode="fsdp"), mesh)

        def shard_batch(b):
            return shd.distribute(b, shd.batch_specs(cfg, b, mesh), mesh)
    state = TrainState(params, init_opt_state(params))
    step_fn = make_train_step(cfg, opt, remat=not on_cpu, accum=args.accum,
                              grad_compression=args.grad_compression,
                              shard_batch=shard_batch)

    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                     batch_size=args.batch, seed=0,
                     rank=info.node if info else 0,
                     world=info.n_nodes if info else 1)
    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    res = TrainResult(cfg.name, cfg.param_count(), args.batch * args.seq, 0,
                      world=world, mesh=mesh.shape)
    if ck and args.resume and ck.latest_step() is not None:
        t0 = time.perf_counter()
        state, extra = ck.restore(state)
        _sync(device)
        res.ckpt_restore_s = time.perf_counter() - t0
        ds.restore(extra["data"])
        start = res.start_step = extra["step"]
        say(f"resumed from step {start}")

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
                say(f"step {step + 1:5d} loss {res.losses[-1]:.4f} "
                    f"lr {float(m['lr']):.2e} "
                    f"gnorm {float(m['grad_norm']):.2f} "
                    f"({dt:.2f}s/step)")
            if ck and (step + 1) % args.ckpt_every == 0:
                ck.save(step + 1, state,
                        extra={"data": ds.state(), "step": step + 1},
                        async_=True)
    if device.type == "cuda":
        res.peak_memory_bytes = torch.cuda.max_memory_allocated(device)
    res.state_bytes = sum(_local_bytes(t) for t in tree_leaves(state))
    if ck:
        t0 = time.perf_counter()
        ck.save(args.steps, state,
                extra={"data": ds.state(), "step": args.steps})
        ck.wait()
        res.ckpt_save_s = time.perf_counter() - t0
    say("done")
    return res


def main(argv=None) -> TrainResult:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
