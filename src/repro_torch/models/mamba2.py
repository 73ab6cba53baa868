"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060] (the port of
``repro/models/mamba2.py``).

Prefill runs the chunked dual form.  Unlike the reference, which leaves
its Pallas kernel out of the model (its ``ssd_chunked`` is an XLA-path
form), ``ssm_block_fwd`` runs every scan, from an empty or a given state,
through ``ops.ssd_scan``: the SSD scan kernel on the card, its plain
version on the CPU.

Decode is the O(1)-per-token recurrent form (``ssm_block_step``).
Parameters keep the reference's layout and names; the port stacks them on
a leading layer axis.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import (causal_conv1d, causal_conv1d_step,
                                       dense_init, rms_norm)


def init_ssm_block(gen: torch.Generator, cfg, n_layers: int, dtype,
                   device) -> Dict:
    """``n_layers`` stacked SSM blocks: every leaf is ``(L, ...)``."""
    L, D, di = n_layers, cfg.d_model, cfg.d_inner
    N, H, K = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    f32 = torch.float32
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=f32,
                                     device=device))
    return {
        "norm": torch.ones((L, D), dtype=dtype, device=device),
        "in_proj": dense_init(gen, (L, D, 2 * di + 2 * N + H), dtype, device),
        "conv_w": dense_init(gen, (L, K, di + 2 * N), dtype, device,
                             scale=0.5),
        "A_log": a_log.expand(L, H).clone(),
        "dt_bias": torch.zeros((L, H), dtype=f32, device=device),
        "D_skip": torch.ones((L, H), dtype=f32, device=device),
        "gate_norm": torch.ones((L, di), dtype=dtype, device=device),
        "out_proj": dense_init(gen, (L, di, D), dtype, device),
    }


def _split_in_proj(cfg, zxbcdt):
    di, N = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    x = zxbcdt[..., di:2 * di]
    B = zxbcdt[..., 2 * di:2 * di + N]
    C = zxbcdt[..., 2 * di + N:2 * di + 2 * N]
    dt = zxbcdt[..., 2 * di + 2 * N:]
    return z, x, B, C, dt


def _conv_in(cfg, zxbcdt):
    """The conv's input [x | B | C]: adjacent in ``zxbcdt``, so a view
    equals the reference's concatenation without copying it."""
    return zxbcdt[..., cfg.d_inner:2 * cfg.d_inner + 2 * cfg.ssm_state]


def ssm_block_fwd(cfg, p, x, *, conv_state=None, ssm_state=None):
    """Full-sequence forward. x: (B, S, D). Returns (y, (conv_state,
    ssm_state)); the scan continues from ``ssm_state`` when given."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    Bsz, S = x.shape[:2]
    h = rms_norm(p["norm"], x, cfg.norm_eps)
    zxbcdt = h @ p["in_proj"]
    z, _, _, _, dt = _split_in_proj(cfg, zxbcdt)
    conv_out, new_conv_state = causal_conv1d(p["conv_w"],
                                             _conv_in(cfg, zxbcdt),
                                             conv_state)
    conv_out = F.silu(conv_out)
    # views of conv_out: the kernel reads them through their strides
    xs = conv_out[..., :di].reshape(Bsz, S, H, P)
    B = conv_out[..., di:di + N]
    C = conv_out[..., di + N:]
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, new_ssm_state = ops.ssd_scan(xs, dt, A, B, C, ssm_state)
    y = y + p["D_skip"].to(y.dtype)[:, None] * xs
    y = y.reshape(Bsz, S, di)
    y = rms_norm(p["gate_norm"], y * F.silu(z), cfg.norm_eps)
    return x + y @ p["out_proj"], (new_conv_state, new_ssm_state)


def ssm_block_step(cfg, p, x_t, conv_state, ssm_state):
    """Single-token decode. x_t: (B, D); states from prefill.  Returns
    (x, (conv_state, ssm_state)) with new state tensors."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    h = rms_norm(p["norm"], x_t, cfg.norm_eps)
    zxbcdt = h @ p["in_proj"]
    z, _, _, _, dt = _split_in_proj(cfg, zxbcdt)
    conv_out, new_conv_state = causal_conv1d_step(p["conv_w"],
                                                  _conv_in(cfg, zxbcdt),
                                                  conv_state)
    conv_out = F.silu(conv_out)
    xs = conv_out[..., :di].reshape(-1, H, P)
    B = conv_out[..., di:di + N].float()
    C = conv_out[..., di + N:].float()
    dt = F.softplus(dt.float() + p["dt_bias"])                   # (B,H)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)                                       # (B,H)
    # h_new = dA * h + dt * B (outer) x
    dBx = torch.einsum("bh,bn,bhp->bhpn", dt, B, xs.float())
    new_state = ssm_state * dA[..., None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", C, new_state).to(x_t.dtype)
    y = y + p["D_skip"].to(y.dtype)[:, None] * xs
    y = y.reshape(-1, di)
    y = rms_norm(p["gate_norm"], y * F.silu(z), cfg.norm_eps)
    return x_t + y @ p["out_proj"], (new_conv_state, new_state)
