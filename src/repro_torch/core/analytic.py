"""Analytic FLOP / byte models per architecture (used by the cold-start
simulator, the roofline report, and EXPERIMENTS.md MODEL_FLOPS).

Conventions:
  * matmul FLOPs = 2 * m * n * k
  * MODEL_FLOPS for training = 6 * N_active * tokens (fwd 2x + bwd 4x)
  * attention FLOPs counted exactly (causal halves the score work)

The port's own copy of ``repro/core/analytic.py``: the per-layer bytes the
load planner partitions and the FLOP and byte models the cold-start
simulator (``core/simulator.py``) prices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import ArchConfig


def param_bytes(cfg: ArchConfig, dtype_bytes: int = 2) -> int:
    return cfg.param_count() * dtype_bytes


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


def embed_bytes(cfg: ArchConfig, dtype_bytes: int = 2) -> int:
    n = cfg.padded_vocab * cfg.d_model
    if not cfg.tie_embeddings:
        n *= 2
    return n * dtype_bytes


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------

def forward_flops(cfg: ArchConfig, batch: int, seq: int, *,
                  kv_len: int = 0) -> float:
    """FLOPs of one forward pass over ``batch*seq`` tokens.

    kv_len > 0 means decode: each token attends to kv_len cached positions.
    """
    T = batch * seq
    D, hd = cfg.d_model, cfg.resolved_head_dim
    f = 0.0
    for kind in cfg.layer_kinds():
        if kind in ("attn", "moe"):
            qkv = 2 * T * D * hd * (cfg.n_heads + 2 * cfg.n_kv_heads)
            o = 2 * T * cfg.n_heads * hd * D
            if kv_len:
                ctx = min(kv_len, cfg.attn_window) if cfg.attn_window else kv_len
                att = 2 * 2 * T * cfg.n_heads * hd * ctx
            else:
                ctx = min(seq, cfg.attn_window) if cfg.attn_window else seq
                att = 2 * 2 * batch * cfg.n_heads * hd * (
                    seq * ctx / 2 if not cfg.attn_window else seq * ctx)
                if not cfg.causal:
                    att = 2 * 2 * batch * cfg.n_heads * hd * seq * seq
            f += qkv + o + att
            if kind == "attn":
                mult = 3 if cfg.gated_mlp else 2
                f += 2 * T * D * cfg.d_ff * mult
            else:
                active = cfg.top_k + cfg.n_shared_experts
                f += 2 * T * D * cfg.moe_d_ff * 3 * active
                f += 2 * T * D * cfg.n_experts  # router
        elif kind == "ssm":
            di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
            f += 2 * T * D * (2 * di + 2 * N + H)          # in_proj
            f += 2 * T * di * D                            # out_proj
            Q = cfg.ssm_chunk if not kv_len else 1
            # SSD: intra-chunk quadratic + state update + state read
            f += 2 * T * H * Q * (N + P)                   # scores + apply
            f += 2 * 2 * T * H * P * N                     # state update/read
        elif kind == "rec":
            W = cfg.lru_width or D
            f += 2 * T * D * W * 2 + 2 * T * W * W * 2 + 2 * T * W * D
            f += 2 * T * D * cfg.d_ff * 3
    # unembed
    f += 2 * T * D * cfg.padded_vocab
    return f


def train_step_flops(cfg: ArchConfig, batch: int, seq: int) -> float:
    return 3.0 * forward_flops(cfg, batch, seq)


def model_flops(cfg: ArchConfig, batch: int, seq: int, kind: str) -> float:
    """The 6·N·D convention (N_active for MoE) used in EXPERIMENTS.md."""
    tokens = batch * seq
    n = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n * tokens
    return 2.0 * n * tokens


def decode_step_bytes(cfg: ArchConfig, batch: int, kv_len: int,
                      dtype_bytes: int = 2) -> float:
    """HBM bytes touched by one decode step (params + cache) — the decode
    roofline is memory-bound, this is its denominator term."""
    b = param_bytes(cfg, dtype_bytes)
    hd = cfg.resolved_head_dim
    for kind in cfg.layer_kinds():
        if kind in ("attn", "moe"):
            ctx = min(kv_len, cfg.attn_window) if cfg.attn_window else kv_len
            b += 2 * batch * ctx * cfg.n_kv_heads * hd * dtype_bytes
        elif kind == "ssm":
            b += batch * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4 * 2
        elif kind == "rec":
            b += batch * (cfg.lru_width or cfg.d_model) * 4 * 2
    return float(b)
