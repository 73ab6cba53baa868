"""Mixture-of-Experts FFN: shared + routed top-k experts with capacity-based
dense dispatch (GShard-style) in prefill and a dropless masked combine in
decode (the port of ``repro/models/moe.py``).

Expert weights are stacked ``(E, ...)`` under a leading layer axis, as the
reference stacks them: ``router (L, D, E)``, ``w_gate``/``w_up`` ``(L, E,
D, F)``, ``w_down`` ``(L, E, F, D)``, and with shared experts ``shared``
``{w_gate, w_up (L, S, D, F), w_down (L, S, F, D), gate (L, D, 1)}``.
Dispatch and combine are dense einsums over a capacity-bounded ``(T, E,
C)`` tensor and the expert products are batched matrix products, as the
reference leaves them to XLA outside any Pallas kernel.

Numerics follow the reference: the router product in the model dtype,
then float32 for the softmax and top-k; the dispatch and combine tensors
cast to the model dtype before their einsums; the shared experts' gate
through a float32 sigmoid, cast back.

The capacity path routes per token group, as the reference does: the
group count is the active sharding policy's ``token_groups``
(``distributed/context.py``), and each group of T / G consecutive tokens
gets its own capacity and expert queues (GShard per-group semantics).
With no policy installed, or a count that does not divide T, there is one
group.  ``serving_capacity_factor`` is unused, as in the reference.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.context import constrain, get_policy
from repro_torch.models.layers import dense_init

# the routing decisions of every MoE call while ``record_routing`` is on
_RECORD: List[Optional[list]] = [None]


@contextlib.contextmanager
def record_routing() -> Iterator[list]:
    """Within the block, every MoE call appends ``(top_e (T, K), keep (T,
    K) bool)`` to the yielded list (``keep`` all True on the dropless path):
    which experts each token chose and which of those (token, choice) pairs
    were inside their expert's capacity.  No host sync is made."""
    prev = _RECORD[0]
    _RECORD[0] = rec = []
    try:
        yield rec
    finally:
        _RECORD[0] = prev


def init_moe_mlp(gen: torch.Generator, cfg, L: int, dtype,
                 device) -> dict:
    """Random MoE weights of ``L`` layers.  The reference's fan-in is the
    leading axis of each per-layer shape, so the expert weights of shape
    (E, D, F) are drawn with std 1/sqrt(E) and the shared ones with
    1/sqrt(S)."""
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.moe_d_ff

    def dense(shape, scale):
        return dense_init(gen, (L,) + shape, dtype, device, scale=scale)

    p = {"router": dense((D, E), 0.02),
         "w_gate": dense((E, D, Fd), E ** -0.5),
         "w_up": dense((E, D, Fd), E ** -0.5),
         "w_down": dense((E, Fd, D), E ** -0.5)}
    if cfg.n_shared_experts:
        S = cfg.n_shared_experts
        p["shared"] = {"w_gate": dense((S, D, Fd), S ** -0.5),
                       "w_up": dense((S, D, Fd), S ** -0.5),
                       "w_down": dense((S, Fd, D), S ** -0.5),
                       "gate": dense((D, 1), 0.02)}
    return p


def moe_capacity(n_tokens: int, cfg,
                 capacity_factor: Optional[float] = None) -> int:
    """Slots per expert: ceil(cf * T * K / E), at least 8, rounded up to a
    multiple of 8."""
    cf = cfg.capacity_factor if capacity_factor is None else capacity_factor
    cap = int(math.ceil(cf * n_tokens * cfg.top_k / cfg.n_experts))
    return max(8, ((cap + 7) // 8) * 8)


def _route(cfg, router, xt):
    """Router softmax and top-k: (probs (T, E), top_p (T, K) renormalised,
    top_e (T, K)) in float32.

    ``jax.lax.top_k`` puts the lower expert index first among equal
    probabilities, and ``torch.topk`` promises no order among ties (on
    CUDA least of all).  In bf16 the router logits are bf16 products cast
    to float32, so ties among dozens of experts do occur: the top k come
    from a stable descending sort, which keeps ties in index order."""
    logits = (xt @ router).float()
    probs = torch.softmax(logits, dim=-1)
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = srt[:, :cfg.top_k], idx[:, :cfg.top_k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return probs, top_p, top_e


def _aux(cfg, probs, onehot):
    """Switch-style load-balance loss: E * sum(frac_tokens * frac_probs) /
    K, onehot (T, K, E)."""
    frac_tokens = onehot.sum(dim=1).mean(dim=0)
    frac_probs = probs.mean(dim=0)
    return (cfg.n_experts * (frac_tokens * frac_probs).sum()
            / cfg.top_k).float()


def _all_experts(xt, w_gate, w_up, w_down, act):
    """act(x W_gate) * (x W_up) W_down of every expert on every token:
    (E, T, D).  The tokens are broadcast over the expert axis, so each
    weight is read where it lies; an einsum over "td,edf" would first lay
    the weights out again, a copy of every expert's weights a call."""
    x = xt.unsqueeze(0)
    h = act(torch.matmul(x, w_gate)) * torch.matmul(x, w_up)    # (E, T, F)
    return torch.bmm(h, w_down)


def _shared(p, xt, act, y):
    """y + the always-on shared experts, gated by a float32 sigmoid."""
    if "shared" not in p:
        return y
    sp = p["shared"]
    ys = _all_experts(xt, sp["w_gate"], sp["w_up"], sp["w_down"],
                      act).sum(dim=0)
    sg = torch.sigmoid((xt @ sp["gate"]).float())
    return y + ys * sg.to(y.dtype)


def _token_groups(T: int) -> int:
    """The installed policy's token groups (dp x seq shards) where they
    divide the T tokens, else 1 (global routing)."""
    pol = get_policy()
    if pol is None:
        return 1
    g = pol.token_groups
    return g if (g > 1 and T % g == 0) else 1


def moe_mlp(cfg, p, x, act, *, dropless: bool = False,
            capacity_factor: Optional[float] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y (B, S, D), aux_loss float32 scalar).

    Routing: softmax -> top-k -> renormalise.  Within each token group
    (``_token_groups``), each (token, choice) pair takes the next slot of
    its expert's queue in token order, then choice order; pairs past the
    expert's capacity C (sized from the group's tokens) are dropped (their
    routed contribution is zero; the shared experts and the residual still
    serve the token).  The load-balance loss is taken over all tokens.
    ``dropless=True`` (decode) runs ``_moe_dropless``."""
    if dropless:
        return _moe_dropless(cfg, p, x, act)
    B, S, D = x.shape
    T = B * S
    G = _token_groups(T)
    xt = constrain(x.reshape(T, D), "tok")
    if G > 1 and getattr(xt, "_local_tensor", xt).shape[0] * G == T:
        y, probs, onehot = _device_groups(cfg, p, xt, act, capacity_factor)
    else:
        parts = [_capacity_group(cfg, p, xg, act, capacity_factor)
                 for xg in xt.chunk(G, dim=0)]
        y = parts[0][0] if G == 1 else torch.cat([q[0] for q in parts])
        if _RECORD[0] is not None:
            _RECORD[0].append(tuple(torch.cat([q[2][i] for q in parts])
                                    for i in range(2)))
        probs = torch.cat([q[1][0] for q in parts])
        onehot = torch.cat([q[1][1] for q in parts])
    y = _shared(p, xt, act, constrain(y, "tok"))
    return y.reshape(B, S, D), _aux(cfg, probs, onehot)


def _device_groups(cfg, p, xt, act, capacity_factor):
    """The capacity path of a DTensor ``xt`` whose tokens are split into
    exactly the policy's groups (the dry run's, ``launch/dryrun.py``):
    each device routes its own group, the expert weights whole on it, as
    the reference's per-group routing runs under its sharding.  Returns
    (y, probs, onehot), split over the devices as ``xt``."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.shardings import row_placements
    names = ("router", "w_gate", "w_up", "w_down")
    tok = tuple(xt.placements)
    _, full, summed = row_placements(tok)

    def group(xl, *weights):
        y, (probs, onehot), _ = _capacity_group(
            cfg, dict(zip(names, weights)), xl, act, capacity_factor)
        return y, probs, onehot
    run = local_map(group, out_placements=(tok, tok, tok),
                    in_placements=(tok,) + (full,) * len(names),
                    in_grad_placements=(tok,) + (summed,) * len(names),
                    redistribute_inputs=True)
    return run(xt, *(p[k] for k in names))


def _capacity_group(cfg, p, xt, act, capacity_factor):
    """The routed experts of one token group xt (T, D): (y (T, D), (probs
    (T, E), onehot (T, K, E)) for the load-balance loss, (top_e, keep) for
    ``record_routing``)."""
    T, D = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    C = moe_capacity(T, cfg, capacity_factor)
    probs, top_p, top_e = _route(cfg, p["router"], xt)

    # position of each (token, choice) in its expert's queue: an exclusive
    # cumsum over the pairs in token order, then choice order
    onehot = F.one_hot(top_e, E).float()                    # (T, K, E)
    flat = onehot.reshape(T * K, E)
    pos = torch.cumsum(flat, dim=0) - flat
    pos = (pos * flat).sum(dim=-1).reshape(T, K)
    keep = pos < C
    pos = torch.where(keep, pos, 0.0).long()

    pos_oh = F.one_hot(pos, C).float()                      # (T, K, C)
    disp = torch.einsum("tke,tkc->tec", onehot * keep[..., None], pos_oh)
    comb = torch.einsum("tke,tkc->tec", onehot * (top_p * keep)[..., None],
                        pos_oh)
    xin = torch.einsum("tec,td->ecd", disp.to(xt.dtype), xt)
    h = act(torch.einsum("ecd,edf->ecf", xin, p["w_gate"])) * \
        torch.einsum("ecd,edf->ecf", xin, p["w_up"])
    eout = torch.einsum("ecf,efd->ecd", h, p["w_down"])     # (E, C, D)
    y = torch.einsum("tec,ecd->td", comb.to(xt.dtype), eout)
    return y, (probs, onehot), (top_e, keep)


def _moe_dropless(cfg, p, x, act) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k MoE: every expert on every token, a masked combine.  A
    decode step of a few tokens is bound by reading every expert's
    weights whatever it computes, so the extra products cost little."""
    B, S, D = x.shape
    E = cfg.n_experts
    T = B * S
    xt = x.reshape(T, D)
    probs, top_p, top_e = _route(cfg, p["router"], xt)
    if _RECORD[0] is not None:
        _RECORD[0].append((top_e, torch.ones_like(top_e, dtype=torch.bool)))
    onehot = F.one_hot(top_e, E).float()                    # (T, K, E)
    w = (onehot * top_p[..., None]).sum(dim=1)              # (T, E)
    eout = _all_experts(xt, p["w_gate"], p["w_up"], p["w_down"], act)
    y = torch.einsum("te,etd->td", w.to(x.dtype), eout)
    y = _shared(p, xt, act, y)
    return y.reshape(B, S, D), _aux(cfg, probs, onehot)
