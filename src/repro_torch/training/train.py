"""Training substrate (the port of ``repro/training/train.py``): the loss,
the train-step factory with remat, gradient accumulation and optional
gradient compression, and ``TrainState``.

Gradients come from ``torch.autograd.grad`` of the loss with respect to
detached copies of the parameter leaves that require a gradient (the
parameters themselves never do), so a step reads like the reference's
``jax.value_and_grad``: parameters in, gradients out.  On the card the
attention, SSD and RG-LRU layers run their kernels, whose autograd
Functions carry the gradients through them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.training.optimizer import (AdamWConfig, OptState,
                                            adamw_update, init_opt_state,
                                            tree_leaves, tree_map)


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def init_train_state(cfg: ArchConfig, gen: torch.Generator, dtype=None,
                     device="cuda") -> TrainState:
    """Random parameters from ``gen`` (a generator on ``device``) and
    zero moments."""
    params = transformer.init_params(cfg, gen, dtype, device)
    return TrainState(params, init_opt_state(params))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean CE over the tokens whose label is not ``ignore_id``, their
    count as float32).  logits (B, S, V) float32, labels (B, S)."""
    mask = labels != ignore_id
    labels_safe = torch.where(mask, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels_safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    denom = torch.clamp(mask.sum(), min=1)
    return nll.sum() / denom, denom.to(torch.float32)


def make_loss_fn(cfg: ArchConfig, *, remat: bool = True):
    """loss_fn(params, batch) -> (ce + router_aux_coef * aux, {"ce",
    "aux", "tokens"})."""
    def loss_fn(params, batch) -> Tuple[torch.Tensor, Dict]:
        logits, aux = transformer.forward(cfg, params, batch, mode="train",
                                          remat=remat)
        ce, n_tok = cross_entropy(logits, batch["labels"])
        loss = ce + cfg.router_aux_coef * aux
        return loss, {"ce": ce, "aux": aux, "tokens": n_tok}
    return loss_fn


def value_and_grad(loss_fn):
    """grad_fn(params, batch) -> ((loss, metrics), grads): the gradient of
    the loss with respect to every parameter leaf, zeros for a leaf the
    loss does not reach (as JAX gives them), in the leaf's dtype."""
    def grad_fn(params, batch):
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss, metrics = loss_fn(leaves, batch)
            flat = tree_leaves(leaves)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        by_id = {id(p): torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)}
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics), tree_map(lambda p: by_id[id(p)],
                                                  leaves)
    return grad_fn


def compress_grads(grads, method: str):
    """Gradient compression before the data-parallel all-reduce: 'bf16'
    casts every gradient to bfloat16."""
    if method == "none":
        return grads
    if method == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16), grads)
    raise ValueError(method)


def _microbatches(batch: Dict, accum: int):
    """The whole batch split in the reference's order: microbatch i holds
    rows [i n, (i + 1) n).  A DTensor batch is refused: slicing it along
    its sharded batch dim would gather it (distribute each microbatch
    instead, ``make_train_step(shard_batch=)``)."""
    if any(type(v).__name__ == "DTensor" for v in batch.values()):
        raise TypeError("split the whole batch, then distribute each "
                        "microbatch (make_train_step(shard_batch=...))")
    B = (batch["tokens"] if "tokens" in batch else batch["embeds"]).shape[0]
    if B % accum:
        raise ValueError(f"batch {B} is not a multiple of accum {accum}")
    n = B // accum
    return [{k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            for i in range(accum)]


def _replicated(x):
    """A DTensor metric (a replicated or partial scalar) as a plain
    tensor, the same on every rank."""
    return x.full_tensor() if type(x).__name__ == "DTensor" else x


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, *,
                    remat: bool = True, accum: int = 1,
                    grad_compression: str = "none",
                    shard_batch: Optional[Callable[[Dict], Dict]] = None
                    ) -> Callable[[TrainState, Dict], Tuple[TrainState,
                                                            Dict]]:
    """Returns train_step(state, batch) -> (state, metrics).

    ``accum`` > 1 splits the batch into microbatches run in sequence
    (gradient accumulation): their gradients are summed in float32 and
    divided by ``accum``; ``metrics["ce"]`` is then the mean loss over the
    microbatches and the other metrics are the last microbatch's, as in
    the reference.  The state's parameters and moments are updated in
    place (the reference donates its state) and returned.

    ``shard_batch`` lays out each (micro)batch of whole tensors for a
    sharded state (``shardings.distribute`` by the batch specs): the step
    takes the whole batch and splits it before distributing.  The
    metrics come back as plain tensors, the same on every rank."""
    grad_fn = value_and_grad(make_loss_fn(cfg, remat=remat))
    place = shard_batch or (lambda b: b)

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict]:
        if accum == 1:
            (loss, metrics), grads = grad_fn(state.params, place(batch))
        else:
            grads, loss = None, 0.0
            for mb in _microbatches(batch, accum):
                (l, metrics), g = grad_fn(state.params, place(mb))
                grads = (tree_map(lambda a: a.float(), g) if grads is None
                         else tree_map(lambda a, b: a + b.float(), grads, g))
                loss = loss + l
            grads = tree_map(lambda g: g / accum, grads)
            loss = loss / accum
            metrics = dict(metrics)
            metrics["ce"] = loss
        grads = compress_grads(grads, grad_compression)
        params, opt, om = adamw_update(opt_cfg, state.params, grads,
                                       state.opt)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = loss
        return TrainState(params, opt), {k: _replicated(v)
                                         for k, v in metrics.items()}

    return train_step


def make_eval_step(cfg: ArchConfig):
    loss_fn = make_loss_fn(cfg, remat=False)

    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = loss_fn(params, batch)
        return {"loss": loss, **metrics}
    return eval_step
