"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060] (the port of
``repro/models/mamba2.py``).

Prefill runs the chunked dual form.  Unlike the reference, which leaves
its Pallas kernel out of the model (its ``ssd_chunked`` is an XLA-path
form), ``ssm_block_fwd`` runs every scan, from an empty or a given state,
through ``ops.ssd_scan``: the SSD scan kernel on the card, its plain
version on the CPU.

Decode is the O(1)-per-token recurrent form (``ssm_block_step``), its
state update and readout one ``ops.ssm_step`` that updates the state in
place (the ``ssm_step`` kernel on the card).  The block is its pre-norm,
the mixer (``mixer_fwd``, ``mixer_step``: in_proj, the causal conv with
its bias where the model has one, the scan, the gated RMSNorm, out_proj)
and the residual add, scaled where the model scales it (granite-4.0-h).
Parameters keep the reference's layout and names; the port stacks them on
a leading layer axis.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.distributed.context import constrain, project
from repro_torch.kernels import ops
from repro_torch.models.layers import (causal_conv1d, causal_conv1d_step,
                                       dense_init, residual_scaled, rms_norm)
from repro_torch.serving.tracing import TRACER


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
        **({"conv_b": dense_init(gen, (L, di + 2 * N), dtype, device,
                                 scale=0.1)} if cfg.ssm_conv_bias else {}),
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
    ssm_state)); the scan continues from ``ssm_state`` when given.  The
    block is the pre-norm, the mixer and the residual add (of the mixer's
    output scaled by ``cfg.residual_multiplier`` where it is not 1)."""
    h = rms_norm(p["norm"], x, cfg.norm_eps)
    y, states = mixer_fwd(cfg, p, h, conv_state=conv_state,
                          ssm_state=ssm_state)
    return constrain(x + residual_scaled(cfg, y), "act"), states


def mixer_fwd(cfg, p, h, *, conv_state=None, ssm_state=None):
    """The Mamba-2 mixer over a normed sequence h (B, S, D): in_proj, the
    causal conv (with its bias where the model has one), the SSD scan
    (``ops.ssd_scan``, inside a ``model.ssm_prefill`` span), the skip, the
    gated RMSNorm ``norm(y * silu(z)) * w`` and out_proj.  Returns (out (B,
    S, D), (conv_state, ssm_state))."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    Bsz, S = h.shape[:2]
    zxbcdt = constrain(project(h, p["in_proj"]), "ffh")
    z, _, _, _, dt = _split_in_proj(cfg, zxbcdt)
    conv_out, new_conv_state = causal_conv1d(p["conv_w"],
                                             _conv_in(cfg, zxbcdt),
                                             conv_state, p.get("conv_b"))
    conv_out = constrain(F.silu(conv_out), "ffh")
    # views of conv_out: the kernel reads them through their strides
    xs = conv_out[..., :di].reshape(Bsz, S, H, P)
    B = conv_out[..., di:di + N]
    C = conv_out[..., di + N:]
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    with TRACER.span("model.ssm_prefill", rows=Bsz, tokens=S):
        y, new_ssm_state = ops.ssd_scan(xs, dt, A, B, C, ssm_state)
    y = y + p["D_skip"].to(y.dtype)[:, None] * xs
    y = y.reshape(Bsz, S, di)
    y = rms_norm(p["gate_norm"], y * F.silu(z), cfg.norm_eps)
    return project(y, p["out_proj"]), (new_conv_state, new_ssm_state)


def ssm_block_step(cfg, p, x_t, conv_state, ssm_state):
    """Single-token decode. x_t: (B, D); states from prefill.  Returns
    (x, (conv_state, ssm_state)): a new conv state tensor, and
    ``ssm_state`` itself, updated in place."""
    h = rms_norm(p["norm"], x_t, cfg.norm_eps)
    y, states = mixer_step(cfg, p, h, conv_state, ssm_state)
    return x_t + residual_scaled(cfg, y), states


def mixer_step(cfg, p, h, conv_state, ssm_state):
    """The mixer on one normed token h (B, D), the O(1) recurrent form:
    the state update, its readout and the D skip are one ``ops.ssm_step``
    on views of the conv's output.  Returns (out (B, D), (conv_state,
    ssm_state)): a new conv state tensor, and ``ssm_state`` itself,
    updated in place."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = h @ p["in_proj"]
    z, _, _, _, dt = _split_in_proj(cfg, zxbcdt)
    conv_out, new_conv_state = causal_conv1d_step(p["conv_w"],
                                                  _conv_in(cfg, zxbcdt),
                                                  conv_state, p.get("conv_b"))
    conv_out = F.silu(conv_out)
    # views of conv_out: the kernel reads them through their strides
    xs = conv_out[..., :di].reshape(-1, H, P)
    y = ops.ssm_step(ssm_state, xs, dt, p["dt_bias"], p["A_log"],
                     conv_out[..., di:di + N], conv_out[..., di + N:],
                     p["D_skip"])
    y = y.reshape(-1, di)
    y = rms_norm(p["gate_norm"], y * F.silu(z), cfg.norm_eps)
    return y @ p["out_proj"], (new_conv_state, ssm_state)
