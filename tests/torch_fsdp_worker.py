"""The ranks of ``tests/test_torch_fsdp.py``: the port's sharded train
path over a ``gloo`` process group on the CPU, one process a rank.

    torchrun --standalone --nproc-per-node 4 tests/torch_fsdp_worker.py \\
        --job DIR --part world4
    torchrun --standalone --nproc-per-node 2 tests/torch_fsdp_worker.py \\
        --job DIR --part world2

Every rank reads the same whole inputs from ``DIR/inputs.pt`` (weights
converted from the reference's, batches from numpy), lays them out as
DTensors by the port's specs, and runs the checks of its world size in one
process group; rank 0 writes every result whole to ``DIR/<part>.pt``;
``world4`` saves a checkpoint to ``DIR/ckpt`` that ``world2`` restores
onto fewer ranks.  The test compares them with the reference's
single-device runs and the port's one-process runs.  The worker imports
torch and ``repro_torch`` only.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.distributed import shardings as shd  # noqa: E402
from repro_torch.distributed.context import (ShardingPolicy,  # noqa: E402
                                             constrain, use_policy)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import Mesh, init_distributed  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.training import optimizer as O  # noqa: E402
from repro_torch.training import train as TT  # noqa: E402
from repro_torch.training.checkpoint import Checkpointer  # noqa: E402
from repro_torch.training.data import SyntheticLM  # noqa: E402

CPU = torch.device("cpu")


def _mesh(shape):
    mesh = Mesh(("data", "model"), shape, (CPU,) * (shape[0] * shape[1]))
    return mesh, mesh.device_mesh(), ShardingPolicy(
        mesh, dp_axes=("data",), seq_axis="model")


def _whole(tree):
    """Every leaf gathered whole into a copy of its own (a collective:
    every rank calls it; a replicated leaf's whole tensor is its shard)."""
    return O.tree_map(lambda x: (x.full_tensor() if type(x).__name__ ==
                                 "DTensor" else x).detach().clone(), tree)


def _state(cfg, params, mesh):
    """A fresh train state from ``params`` (whole), sharded FSDP."""
    st = TT.TrainState(params, O.init_opt_state(params))
    pspec = shd.param_specs(cfg, params, mesh, mode="fsdp")
    return shd.distribute(st, TT.TrainState(
        pspec, O.OptState(shd.P(), pspec, pspec)), mesh), pspec


def _placer(cfg, mesh):
    return lambda b: shd.distribute(b, shd.batch_specs(cfg, b, mesh), mesh)


def forward_logits(job, out):
    """(a) the reduced qwen3's train-mode logits on (2, 2), the sequence
    split over 'model'."""
    cfg = get_arch("qwen3-1.7b").reduced(n_layers=4, vocab_size=256)
    mesh, _, pol = _mesh((2, 2))
    p = shd.distribute(job["qwen3"]["params"], shd.param_specs(
        cfg, job["qwen3"]["params"], mesh, mode="fsdp"), mesh)
    b = _placer(cfg, mesh)(job["qwen3"]["batch"])
    with use_policy(pol):
        logits, _ = T.forward(cfg, p, b, mode="train")
    out["qwen3_placements"] = [repr(x) for x in logits.placements]
    out["qwen3_local_shape"] = tuple(logits.to_local().shape)
    out["qwen3_logits"] = logits.full_tensor()


def train_steps(job, out):
    """(b) three steps of the reduced opt-1.3b on (4, 1) and (2, 2), accum
    1 and 2."""
    cfg = get_arch("pipeboost-opt-1.3b").reduced()
    opt = O.AdamWConfig(**job["opt_cfg"])
    for shape in ((4, 1), (2, 2)):
        mesh, _, pol = _mesh(shape)
        for accum in (1, 2):
            st, _ = _state(cfg, job["opt"]["params"], mesh)
            step = TT.make_train_step(cfg, opt, remat=False, accum=accum,
                                      shard_batch=_placer(cfg, mesh))
            metrics = []
            with use_policy(pol):
                for b in job["opt"]["batches"][accum]:
                    st, m = step(st, b)
                    metrics.append({k: float(v) for k, v in m.items()})
            key = f"opt_{shape[0]}x{shape[1]}_accum{accum}"
            out[key] = {"metrics": metrics, "state": _whole(st)}


def loss_and_grads(job, out, runs):
    """The loss and every gradient leaf, gathered whole, of each (arch,
    mesh shape) in ``runs``: (c) mamba2 and recurrentgemma on (2, 2), (d)
    qwen2-moe on (2, 1)."""
    for arch, shape in runs:
        cfg = get_arch(arch).reduced()
        mesh, _, pol = _mesh(shape)
        params = job[arch]["params"]
        p = shd.distribute(params, shd.param_specs(cfg, params, mesh,
                                                   mode="fsdp"), mesh)
        b = _placer(cfg, mesh)(job[arch]["batch"])
        grad_fn = TT.value_and_grad(TT.make_loss_fn(cfg, remat=False))
        with use_policy(pol):
            (loss, _), grads = grad_fn(p, b)
        out[arch] = {"loss": float(loss.full_tensor()),
                     "grads": _whole(grads)}


def _grads_of(fn, inputs, weights):
    """The outputs of ``fn(*inputs)`` and the gradients of sum(output *
    weight) with respect to the inputs, all gathered whole."""
    ins = [x.detach().requires_grad_() for x in inputs]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    total = sum((o * w).sum() for o, w in zip(outs, weights))
    grads = torch.autograd.grad(total, ins)
    return _whole(list(outs)), _whole(list(grads)), outs[0]


def kernel_routes(job, out):
    """flash, the SSD scan and the RG-LRU scan given DTensors split (dp,
    seq) on (2, 2), against the same calls on plain tensors."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    k = job["kernels"]
    mesh, dmesh, pol = _mesh((2, 2))
    rows_seq = shd.placements(shd.P("data", "model"), mesh)
    whole = (Replicate(), Replicate())

    def dt(x, pl=rows_seq):
        return distribute_tensor(x, dmesh, pl, src_data_rank=None)
    y_ssd = torch.ones(4, 4, 16, 128)
    cases = {
        "flash_attention": (
            lambda q, kk, v: ops.flash_attention(q, kk, v, causal=True),
            (k["q"], k["kv"][0], k["kv"][1]), (k["dy"],), None),
        "ssd_scan": (
            ops.ssd_scan, (k["x"], k["dt"], k["A"], k["BC"][0], k["BC"][1]),
            (k["x"], y_ssd), 2),
        "rglru_scan": (
            ops.rglru_scan, (k["log_a"], k["bx"]),
            (k["bx"], torch.ones(4, 24)), None),
    }
    res = {}
    with use_policy(pol):
        for name, (fn, ins, ws, repl) in cases.items():
            d_ins = [dt(x, whole if i == repl else rows_seq)
                     for i, x in enumerate(ins)]
            d_ws = [dt(w) if w.dim() >= 3 and w.shape[1] == 32 else
                    dt(w, shd.placements(shd.P("data"), mesh)) for w in ws]
            o, g, lead = _grads_of(fn, d_ins, d_ws)
            po, pg, _ = _grads_of(fn, ins, ws)
            res[name] = {
                "placements": [repr(p) for p in lead.placements],
                "pairs": {**{f"out{i}": (a, b) for i, (a, b) in
                             enumerate(zip(o, po))},
                          **{f"grad{i}": (a, b) for i, (a, b) in
                             enumerate(zip(g, pg))}}}
    out["kernels"] = res


def constrain_roles(out):
    """Each role of the (2, 2) policy on real shards: a replicated DTensor
    pinned to it (``constrain``) lies as the role's spec puts it and keeps
    its values; the policy's token groups are its dp x seq ranks."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    mesh, dmesh, pol = _mesh((2, 2))
    shapes = {"act": (4, 8, 16), "ffh": (4, 8, 32), "heads": (4, 8, 4, 16),
              "logits": (4, 8, 64), "tok": (32, 16)}
    res = {}
    with use_policy(pol):
        for role, shape in shapes.items():
            x = torch.randn(shape, generator=torch.Generator().manual_seed(0))
            c = constrain(distribute_tensor(x, dmesh, (Replicate(),) * 2),
                          role)
            want = shd.placements(pol.spec(role, len(shape)), mesh)
            res[role] = ([repr(p) for p in c.placements],
                         [repr(p) for p in want],
                         bool(torch.equal(c.full_tensor(), x)))
    out["roles"] = res
    out["token_groups"] = pol.token_groups


def refusals(out):
    """decode attention and the LoRA merge given DTensors."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    mesh, dmesh, _ = _mesh((2, 1))

    def dt(*shape):
        return distribute_tensor(torch.zeros(shape), dmesh,
                                 (Replicate(), Replicate()))
    calls = {
        "decode_attention": lambda: ops.decode_attention(
            dt(2, 1, 4, 64), dt(2, 8, 4, 64), dt(2, 8, 4, 64),
            torch.ones(2, dtype=torch.int32)),
        "lora_merge": lambda: ops.lora_merge(dt(2, 64, 64), dt(2, 64, 4),
                                             dt(2, 4, 64), 1.0),
    }
    refused = {}
    for name, call in calls.items():
        try:
            call()
        except TypeError as e:
            refused[name] = f"TypeError: {e}"
    out["refused"] = refused


def elastic_save(job, out, ckdir):
    """Two steps of the reduced qwen3 (2 layers) on (2, 2), saved."""
    e = job["elastic"]
    cfg = get_arch("qwen3-1.7b").reduced(n_layers=2, vocab_size=256)
    mesh, _, pol = _mesh((2, 2))
    st, _ = _state(cfg, e["params"], mesh)
    step = TT.make_train_step(cfg, O.AdamWConfig(**job["opt_cfg"]),
                              remat=False,
                              shard_batch=_placer(cfg, mesh))
    ds = SyntheticLM(vocab_size=256, seq_len=16, batch_size=8, seed=2)
    with use_policy(pol):
        for _ in range(2):
            st, _m = step(st, {k: torch.from_numpy(v)
                               for k, v in ds.next_batch().items()})
    Checkpointer(ckdir).save(2, st, extra={"data": ds.state(), "step": 2})
    out["elastic_saved"] = _whole(st)


def elastic_restore(job, out, ckdir):
    """The 4-rank checkpoint restored onto (2, 1) with ``shardings=``,
    then one more step."""
    e = job["elastic"]
    cfg = get_arch("qwen3-1.7b").reduced(n_layers=2, vocab_size=256)
    mesh, dmesh, pol = _mesh((2, 1))
    tmpl = TT.TrainState(e["params"], O.init_opt_state(e["params"]))
    pspec = shd.param_specs(cfg, tmpl.params, mesh, mode="fsdp")
    sspec = TT.TrainState(pspec, O.OptState(shd.P(), pspec, pspec))
    st, extra = Checkpointer(ckdir).restore(
        tmpl, shardings=shd.named(mesh, sspec), device=dmesh)
    out["elastic_restored_placements"] = [
        [repr(p) for p in x.placements] for x in O.tree_leaves(st)]
    out["elastic_restored"] = _whole(st)
    ds = SyntheticLM(vocab_size=256, seq_len=16, batch_size=8, seed=2)
    ds.restore(extra["data"])
    step = TT.make_train_step(cfg, O.AdamWConfig(**job["opt_cfg"]),
                              remat=False,
                              shard_batch=_placer(cfg, mesh))
    with use_policy(pol):
        st, m = step(st, {k: torch.from_numpy(v)
                          for k, v in ds.next_batch().items()})
    out["elastic_loss"] = float(m["loss"])
    out["elastic_continued"] = _whole(st)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--job", required=True)
    ap.add_argument("--part", choices=("world4", "world2"), required=True)
    args = ap.parse_args(argv)
    info = init_distributed(device_type="cpu")
    shd.register_strategies()
    d = Path(args.job)
    job = torch.load(d / "inputs.pt", weights_only=False)
    out = {"world": info.world}
    if args.part == "world4":
        parts = [lambda: forward_logits(job, out),
                 lambda: constrain_roles(out),
                 lambda: kernel_routes(job, out),
                 lambda: train_steps(job, out),
                 lambda: loss_and_grads(job, out, (
                     ("mamba2-780m", (2, 2)), ("recurrentgemma-2b", (2, 2)))),
                 lambda: elastic_save(job, out, str(d / "ckpt"))]
    else:
        parts = [lambda: loss_and_grads(job, out,
                                        (("qwen2-moe-a2.7b", (2, 1)),)),
                 lambda: refusals(out),
                 lambda: elastic_restore(job, out, str(d / "ckpt"))]
    for i, part in enumerate(parts):
        t0 = time.perf_counter()
        part()
        if info.rank == 0:
            print(f"part {i}: {time.perf_counter() - t0:.1f} s", flush=True)
    if info.rank == 0:
        torch.save(out, d / f"{args.part}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
