"""RG-LRU recurrent block (Griffin / RecurrentGemma) [arXiv:2402.19427]
(the port of ``repro/models/rglru.py``).

Recurrence:  a_t = exp(-c * softplus(Lambda) * r_t),
             h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
with r_t, i_t sigmoid gates.  The reference's full-sequence form is a
log-space associative scan (its Pallas kernel stays out of its model);
the port's ``rec_block_fwd`` runs every scan, from zeros or from a given
h0, through ``ops.rglru_scan``: the RG-LRU kernel on the card, its plain
version on the CPU.  Decode is the O(1) elementwise step
(``rec_block_step``), which runs no kernel, as in the reference.

The surrounding residual block is Griffin's: conv1d front, gated output
branch, then a GeGLU MLP (built in transformer.py).  Parameters keep the
reference's names; the port stacks them on a leading layer axis.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.distributed.context import constrain
from repro_torch.kernels import ops
from repro_torch.models.layers import (_ACTS, causal_conv1d,
                                       causal_conv1d_step, dense_init)

C_CONST = 8.0


def init_rec_block(gen: torch.Generator, cfg, n_layers: int, dtype,
                   device) -> Dict:
    """``n_layers`` stacked recurrent blocks: every leaf is ``(L, ...)``.
    ``Lambda`` is the reference's: a ~ Uniform(0.9, 0.999) at r = 1
    (Griffin A.2), so random weights decay like trained ones."""
    L, D = n_layers, cfg.d_model
    W = cfg.lru_width or D
    lam = torch.log(torch.expm1(-torch.log(torch.linspace(
        0.9, 0.999, W, dtype=torch.float32, device=device)) / C_CONST))
    return {
        "w_gate_branch": dense_init(gen, (L, D, W), dtype, device),
        "w_x_branch": dense_init(gen, (L, D, W), dtype, device),
        "conv_w": dense_init(gen, (L, cfg.ssm_conv, W), dtype, device,
                             scale=0.5),
        "w_rec_gate": dense_init(gen, (L, W, W), dtype, device),
        "w_in_gate": dense_init(gen, (L, W, W), dtype, device),
        "Lambda": lam.expand(L, W).clone(),
        "w_out": dense_init(gen, (L, W, D), dtype, device),
    }


def _gates(p, x):
    """log(a_t) and the gated input. x: (..., W) conv output (float32);
    the gate products run in float32 from upcast weights."""
    r = torch.sigmoid(x @ p["w_rec_gate"].float())
    i = torch.sigmoid(x @ p["w_in_gate"].float())
    log_a = -C_CONST * F.softplus(p["Lambda"]) * r            # (..., W) <= 0
    a2 = torch.exp(2.0 * log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * (i * x)
    return log_a, gated_x


def rec_block_fwd(cfg, p, x, *, conv_state=None, h0=None):
    """Temporal-mixing branch of a Griffin recurrent block.

    x: (B, S, D) (already normed by the caller).  The scan continues from
    ``h0`` (B, W) float32 when given.  Returns (y (B, S, D), (conv_state,
    h_last (B, W) float32))."""
    gate = constrain(_ACTS["gelu"](x @ p["w_gate_branch"]), "ffh")
    u = constrain(x @ p["w_x_branch"], "ffh")
    u, new_conv_state = causal_conv1d(p["conv_w"], u, conv_state)
    log_a, bx = _gates(p, u.float())
    h, h_last = ops.rglru_scan(log_a, bx, h0)
    h = constrain(h, "ffh")
    y = (h.to(x.dtype) * gate) @ p["w_out"]
    return y, (new_conv_state, h_last)


def rec_block_step(cfg, p, x_t, conv_state, h):
    """Single-token decode. x_t: (B, D); h: (B, W) float32.  Returns
    (y (B, D), (conv_state, h_new)) with new state tensors."""
    gate = _ACTS["gelu"](x_t @ p["w_gate_branch"])
    u = x_t @ p["w_x_branch"]
    u, new_conv_state = causal_conv1d_step(p["conv_w"], u, conv_state)
    log_a, bx = _gates(p, u.float())
    h_new = torch.exp(log_a) * h + bx
    y = (h_new.to(x_t.dtype) * gate) @ p["w_out"]
    return y, (new_conv_state, h_new)
