"""AdamW with linear warmup and cosine decay, global-norm clipping and
decoupled weight decay on matrices only (the port of
``repro/training/optimizer.py``; no ``torch.optim``).

Parameters, gradients and moments are trees of tensors (nested dicts and
sequences, as ``transformer.init_params`` builds them).  The moments are
float32 whatever the parameters' dtype; each update computes in float32
and casts the new parameter back to its dtype.  ``adamw_update`` updates
the parameters and moments in place, one leaf at a time — the analogue of
the reference's donated train state — and returns them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Tuple

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor   # () int32
    m: Any               # tree like params (float32)
    v: Any               # tree like params (float32)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree in the reference's leaf order (dict keys
    sorted, sequences in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else \
            type(tree)(vals)
    return fn(tree, *rest)


def init_opt_state(params) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                    tree_map(zeros, params), tree_map(zeros, params))


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_frac``, float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    total = None
    for x in tree_leaves(tree):
        sq = x.float().square().sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads in float32 scaled to a global norm of at most ``max_norm``,
    the norm before clipping)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), gn


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: OptState
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step on every leaf: clip the gradients by their global
    norm, update the float32 moments, apply the bias-corrected step plus
    decoupled weight decay on every leaf of ``ndim >= 2`` (the reference's
    rule: stacked norm weights (L, D) are decayed too), cast back to the
    parameter's dtype.  The parameters and moments are updated in place,
    leaf by leaf (the clipped float32 gradient exists for one leaf at a
    time), and returned with {"lr", "grad_norm"}."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, cfg.grad_clip)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
    flat = zip(tree_leaves(params), tree_leaves(grads),
               tree_leaves(state.m), tree_leaves(state.v))
    for p, g, m, v in flat:
        g = g.float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g.square())
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if p.ndim >= 2:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, OptState(step, state.m, state.v), {"lr": lr,
                                                      "grad_norm": gn}
