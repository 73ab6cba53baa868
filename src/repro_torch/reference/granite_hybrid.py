"""granite-4.0-h (``GraniteMoeHybridForCausalLM``) in plain float32 torch:
the full forward over token ids, one sequence, no cache, no batching and
no kernel, TF32 off.  It imports nothing of the port; ``cfg`` is any object
with the port's ``ArchConfig`` attribute names and ``params`` the port's
parameter tree, read as float32.

The equations (transformers' ``models/granitemoehybrid``):

* ``x = embed[ids] * embedding_multiplier``;
* every layer: ``x = x + residual_multiplier * mixer(rms_norm(x, ln1))``,
  then ``x = x + residual_multiplier * (moe(h) + shared_mlp(h))`` with
  ``h = rms_norm(x, ln2)``;
* a Mamba-2 mixer: ``[z | xBC | dt] = h in_proj``; ``xBC = silu(conv(xBC)
  + conv_b)`` (causal, width ``ssm_conv``); ``[x | B | C] = xBC`` (one
  group); ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``; per head
  ``s_t = exp(dt_t A) s_{t-1} + dt_t x_t B_tᵀ``, ``y_t = s_t C_t + D x_t``;
  ``out = (rms_norm(y * silu(z)) * gate_norm) out_proj`` (the norm over all
  ``d_inner`` channels, eps ``norm_eps``);
* an attention mixer: q, k, v projections without bias, no position
  embedding, ``softmax(q kᵀ * attention_multiplier)`` causal over GQA
  groups, ``wo``;
* the MoE: router logits ``h router``, the top k of them, a softmax over
  those k; each chosen expert ``(silu(h W_gate) * (h W_up)) W_down`` times
  its weight; the shared MLP the same SwiGLU at its own width, added with
  no gate;
* ``logits = rms_norm(x, final_norm) embedᵀ / logits_scaling`` (tied).

Departures from the published computation, none of them in the
mathematics: the projections are stored as (in, out) matrices (the port's
layout, the transpose of ``nn.Linear``'s), the expert and shared weights
split into ``w_gate`` / ``w_up`` (the two halves of ``input_linear``), the
SSM runs its recurrence one step at a time (the published code's
``torch_forward`` runs the same recurrence chunked), and ties among router
logits go to the lower expert index.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch
import torch.nn.functional as F


def _f(t):
    return t.float()


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * _f(w)


def swiglu(h, w_gate, w_up, w_down):
    return (F.silu(h @ _f(w_gate)) * (h @ _f(w_up))) @ _f(w_down)


def mamba_mixer(cfg, p: Dict, h):
    """h (S, D) normed -> (S, D)."""
    S = h.shape[0]
    di, N, P = cfg.ssm_expand * cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim
    H, K = di // P, cfg.ssm_conv
    zxbcdt = h @ _f(p["in_proj"])
    z, xbc, dt = zxbcdt[:, :di], zxbcdt[:, di:2 * di + 2 * N], \
        zxbcdt[:, 2 * di + 2 * N:]
    pad = torch.cat([xbc.new_zeros(K - 1, xbc.shape[1]), xbc])
    w = _f(p["conv_w"])                                     # (K, channels)
    conv = sum(pad[i:i + S] * w[i] for i in range(K))
    if "conv_b" in p:
        conv = conv + _f(p["conv_b"])
    xbc = F.silu(conv)
    x, B, C = xbc[:, :di].view(S, H, P), xbc[:, di:di + N], xbc[:, di + N:]
    dt = F.softplus(dt + _f(p["dt_bias"]))                  # (S, H)
    A = -torch.exp(_f(p["A_log"]))
    s = h.new_zeros(H, P, N)
    ys = []
    for t in range(S):
        s = torch.exp(dt[t] * A)[:, None, None] * s + \
            dt[t][:, None, None] * x[t][:, :, None] * B[t][None, None, :]
        ys.append(s @ C[t])                                 # (H, P)
    y = torch.stack(ys) + _f(p["D_skip"])[:, None] * x
    y = y.reshape(S, di) * F.silu(z)
    return rms_norm(y, p["gate_norm"], cfg.norm_eps) @ _f(p["out_proj"])


def attention_mixer(cfg, p: Dict, h):
    """h (S, D) normed -> (S, D): causal GQA, no position embedding."""
    S = h.shape[0]
    hd, Hq, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = (h @ _f(p["wq"])).view(S, Hq, hd).transpose(0, 1)
    k = (h @ _f(p["wk"])).view(S, Hkv, hd).transpose(0, 1)
    v = (h @ _f(p["wv"])).view(S, Hkv, hd).transpose(0, 1)
    k = k.repeat_interleave(Hq // Hkv, dim=0)
    v = v.repeat_interleave(Hq // Hkv, dim=0)
    sc = (q @ k.transpose(1, 2)) * cfg.attention_multiplier
    mask = torch.ones(S, S, dtype=torch.bool, device=h.device).triu(1)
    o = torch.softmax(sc.masked_fill(mask, float("-inf")), dim=-1) @ v
    return o.transpose(0, 1).reshape(S, Hq * hd) @ _f(p["wo"])


def moe_ffn(cfg, p: Dict, h):
    """h (S, D) normed -> (S, D): the top-k experts and the shared MLP."""
    logits = h @ _f(p["router"])
    srt, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(srt[:, :cfg.top_k], dim=-1)
    top_e = idx[:, :cfg.top_k]
    y = torch.zeros_like(h)
    for e in range(cfg.n_experts):
        rows, ks = (top_e == e).nonzero(as_tuple=True)
        if rows.numel():
            out = swiglu(h[rows], p["w_gate"][e], p["w_up"][e],
                         p["w_down"][e])
            y.index_add_(0, rows, out * gates[rows, ks][:, None])
    sh = p["shared"]
    for i in range(sh["w_gate"].shape[0]):
        y = y + swiglu(h, sh["w_gate"][i], sh["w_up"][i], sh["w_down"][i])
    return y


def forward(cfg, params: Dict, ids: torch.Tensor) -> torch.Tensor:
    """Logits (S, V) float32 of one sequence of token ids (S,)."""
    with no_tf32():
        x = _f(params["embed"])[ids] * cfg.embedding_multiplier
        rm = cfg.residual_multiplier
        count: Dict[str, int] = {}
        for kind in cfg.layer_kinds():
            i = count.get(kind, 0)
            count[kind] = i + 1
            p = {k: (v[i] if not isinstance(v, dict) else _layer(v, i))
                 for k, v in params["blocks"][kind].items()}
            if kind == "ssm":
                x = x + rm * mamba_mixer(cfg, p, rms_norm(x, p["norm"],
                                                          cfg.norm_eps))
            else:
                x = x + rm * attention_mixer(cfg, p, rms_norm(
                    x, p["ln1"], cfg.norm_eps))
            x = x + rm * moe_ffn(cfg, p["mlp"], rms_norm(x, p["ln2"],
                                                          cfg.norm_eps))
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return (x @ _f(params["embed"]).T)[:, :cfg.vocab_size] \
            / cfg.logits_scaling


def _layer(tree: Dict, i: int) -> Dict:
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """Float32 products in float32 (TF32 off) within the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
