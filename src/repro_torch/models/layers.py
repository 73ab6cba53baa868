"""Core layers: norms, rotary embeddings, MLPs, the causal depthwise conv
(the port of ``repro/models/layers.py``).

Parameters are plain dicts of tensors; every layer is a function
``f(params, x, ...)``.  Initializers take an explicit ``torch.Generator``.
Numerics follow the reference: norms and RoPE compute in float32 and cast
back; RoPE is split-half (not interleaved) with float32 angles; ``gelu`` is
the tanh approximation (``jax.nn.gelu``'s default).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype, device,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init; ``shape`` may carry a leading layer
    axis, fan-in is then ``shape[-2]``."""
    fan_in = shape[-2] if len(shape) > 1 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    w = torch.randn(shape, dtype=torch.float32, device=device, generator=gen)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(w, x, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * w.float()).to(dt)


def layer_norm(params, x, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Split-half RoPE. x: (..., S, H, hd); positions broadcastable to
    (..., S)."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].float() * inv          # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


_ACTS = {
    "silu": F.silu,
    "gelu": _gelu_tanh,
    "relu": F.relu,
}


def mlp(params: Dict, x, act: str = "silu"):
    """Gated (SwiGLU-family) MLP: down( act(x@gate) * (x@up) )."""
    a = _ACTS[act]
    h = a(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# Causal depthwise conv1d (mamba2 front conv)
# ---------------------------------------------------------------------------

def causal_conv1d(w, x, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along time.

    w: (K, C); x: (B, S, C); state: (B, K-1, C) carry of previous inputs.
    Returns (y, new_state) with y: (B, S, C), new_state: (B, K-1, C).
    """
    K = w.shape[0]
    S = x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[-1]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)               # (B, S+K-1, C)
    y = xp[:, 0:S] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i]
    new_state = xp[:, S:] if K > 1 else state
    return y, new_state


def causal_conv1d_step(w, x_t, state):
    """Single decode step. x_t: (B, C); state: (B, K-1, C)."""
    window = torch.cat([state, x_t[:, None, :]], dim=1)   # (B, K, C)
    y = torch.einsum("bkc,kc->bc", window, w)
    return y, window[:, 1:]
