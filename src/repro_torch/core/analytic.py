"""Analytic byte model per architecture (own copy of the byte half of
``repro/core/analytic.py``): the per-layer parameter bytes the load
planner partitions into segments."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig


def layer_bytes_list(cfg: ArchConfig, dtype_bytes: int = 2):
    """Per-layer parameter bytes (embedding/head excluded — they are loaded
    with the first/last segments by the loading engine)."""
    D, hd = cfg.d_model, cfg.resolved_head_dim
    out = []
    for kind in cfg.layer_kinds():
        n = 2 * D
        if kind == "attn":
            n += D * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * D
            n += (3 if cfg.gated_mlp else 2) * D * cfg.d_ff
        elif kind == "moe":
            n += D * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * D
            n += D * cfg.n_experts
            n += (cfg.n_experts + cfg.n_shared_experts) * 3 * D * cfg.moe_d_ff
        elif kind == "ssm":
            di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
            n += D * (2 * di + 2 * N + H) + (di + 2 * N) * cfg.ssm_conv
            n += 2 * H + di + di * D
        elif kind == "rec":
            W = cfg.lru_width or D
            n += 2 * D * W + W * cfg.ssm_conv + 2 * W * W + W + W * D
            n += 3 * D * cfg.d_ff
        out.append(int(n) * dtype_bytes)
    return out

