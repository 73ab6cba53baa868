"""Config system: architecture + input-shape configs and the cell matrix.

Every assigned architecture is an ``ArchConfig`` (frozen dataclass) registered
in ``ARCH_REGISTRY`` by its public id (``--arch <id>``).  Input shapes are
``ShapeConfig`` entries in ``SHAPES``.  ``cells()`` enumerates the assigned
(arch x shape) matrix minus the skips documented in DESIGN.md §5.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    """A single architecture from the assigned pool (exact public config)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- attention options -------------------------------------------------
    qk_norm: bool = False          # RMSNorm on q/k per-head (qwen3)
    qkv_bias: bool = False         # bias on qkv projections (qwen2.5 family)
    attn_window: int = 0           # 0 = full; >0 = sliding local window
    rope_theta: float = 1e6
    mrope: bool = False            # multimodal section-wise rotary (qwen2-vl)
    mrope_sections: Tuple[int, ...] = (16, 24, 24)  # t,h,w splits of head_dim/2
    causal: bool = True            # False => encoder-only (hubert)

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0              # per-expert hidden dim
    capacity_factor: float = 1.25
    serving_capacity_factor: float = 2.0
    router_aux_coef: float = 0.01

    # --- SSM (mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0             # N
    ssm_expand: int = 2
    ssm_head_dim: int = 64         # P
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- hybrid (recurrentgemma) --------------------------------------------
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    lru_width: int = 0

    # --- misc ----------------------------------------------------------------
    act: str = "silu"
    gated_mlp: bool = True
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""               # public provenance [source; tier]

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.n_heads:
            return self.d_model // self.n_heads
        return 0

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (Megatron-style) so the vocab
        dim shards cleanly over any mesh axis we use (<=256-way)."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can serve 500k+ contexts (SSM / windowed / hybrid)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.attn_window > 0

    @property
    def has_decode(self) -> bool:
        """Encoder-only archs have no autoregressive decode step."""
        return self.causal

    def layer_kinds(self) -> List[str]:
        """Per-layer block kind, resolving the hybrid pattern."""
        if self.family == "hybrid" and self.block_pattern:
            pat = self.block_pattern
            return [pat[i % len(pat)] for i in range(self.n_layers)]
        if self.family == "ssm":
            return ["ssm"] * self.n_layers
        if self.family == "moe":
            return ["moe"] * self.n_layers
        return ["attn"] * self.n_layers

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        D, V = self.d_model, self.padded_vocab
        hd = self.resolved_head_dim
        n = V * D  # embedding
        if not self.tie_embeddings:
            n += V * D  # lm head
        n += D  # final norm
        kinds = self.layer_kinds()
        for kind in kinds:
            n += 2 * D  # the two pre-norms (single for ssm, counted anyway)
            if kind == "attn":
                q = D * self.n_heads * hd + (self.n_heads * hd if self.qkv_bias else 0)
                kv = 2 * (D * self.n_kv_heads * hd + (self.n_kv_heads * hd if self.qkv_bias else 0))
                o = self.n_heads * hd * D
                n += q + kv + o
                if self.qk_norm:
                    n += 2 * hd
                n += (3 if self.gated_mlp else 2) * D * self.d_ff
            elif kind == "moe":
                q = D * self.n_heads * hd
                kv = 2 * D * self.n_kv_heads * hd
                o = self.n_heads * hd * D
                n += q + kv + o
                n += D * self.n_experts  # router
                n += self.n_experts * 3 * D * self.moe_d_ff
                n += self.n_shared_experts * 3 * D * self.moe_d_ff
            elif kind == "ssm":
                di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
                # in_proj: z, x, B, C, dt
                n += D * (2 * di + 2 * N + H)
                n += (di + 2 * N) * self.ssm_conv  # conv1d
                n += 2 * H + di  # A_log, dt_bias, D skip (di)
                n += di * D  # out_proj
            elif kind == "rec":
                w = self.lru_width or D
                n += 2 * D * w      # gate branch + x branch
                n += w * self.ssm_conv
                n += 2 * w * w // 1 if False else 0
                n += 2 * w          # input gate, recurrence gate (diagonal blocks approximated dense below)
                n += 2 * w * w // 16  # block-diagonal gates (16 blocks) approx
                n += w              # Lambda
                n += w * D          # out proj
                n += 3 * D * self.d_ff  # the mlp in a recurrent block
        return int(n)

    def active_param_count(self) -> int:
        """Active params per token (MoE: shared + top_k experts only)."""
        if self.family != "moe":
            return self.param_count()
        D = self.d_model
        dense = self.param_count()
        all_exp = self.n_layers * self.n_experts * 3 * D * self.moe_d_ff
        act_exp = self.n_layers * self.top_k * 3 * D * self.moe_d_ff
        return int(dense - all_exp + act_exp)

    def reduced(self, **overrides) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw: Dict = dict(
            n_layers=min(self.n_layers, 2 * max(1, len(self.block_pattern) or 1)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=128,
            vocab_size=257,
            head_dim=16,
        )
        if self.family == "moe":
            kw.update(n_experts=4, top_k=min(self.top_k, 2), moe_d_ff=32,
                      n_shared_experts=min(self.n_shared_experts, 1),
                      capacity_factor=8.0)  # dropless at test scale
        if self.family == "ssm":
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
        if self.mrope:
            kw.update(mrope_sections=(2, 3, 3))  # sums to head_dim(16)//2
        if self.family == "hybrid":
            kw.update(lru_width=64, attn_window=min(self.attn_window or 0, 32) or 32)
        elif self.attn_window:
            kw.update(attn_window=32)
        kw.update(dtype="float32")
        kw.update(overrides)
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input-shape configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS: List[str] = [
    "mamba2-780m",
    "qwen3-1.7b",
    "deepseek-coder-33b",
    "granite-3-8b",
    "qwen2.5-14b",
    "hubert-xlarge",
    "qwen2-vl-72b",
    "qwen2-moe-a2.7b",
    "phi3.5-moe-42b-a6.6b",
    "recurrentgemma-2b",
    # the paper's own evaluation family (OPT-1.3B-like) used by benchmarks
    "pipeboost-opt-1.3b",
]

_MODULE_FOR: Dict[str, str] = {
    "mamba2-780m": "mamba2_780m",
    "qwen3-1.7b": "qwen3_1_7b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "granite-3-8b": "granite_3_8b",
    "qwen2.5-14b": "qwen2_5_14b",
    "hubert-xlarge": "hubert_xlarge",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "pipeboost-opt-1.3b": "pipeboost_opt_1_3b",
}


def get_arch(name: str) -> ArchConfig:
    if name not in _MODULE_FOR:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULE_FOR)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[name]}")
    return mod.CONFIG


def cell_is_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) for one (arch x shape) cell."""
    if shape.kind == "decode" and not arch.has_decode:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "pure full-attention arch cannot serve 524k context"
    return True, ""


def cells(include_skipped: bool = False):
    """Enumerate the assigned (arch x shape) matrix (DESIGN.md §5)."""
    out = []
    for aid in ARCH_IDS:
        if aid == "pipeboost-opt-1.3b":
            continue  # paper's own model: benchmarks only, not an assigned cell
        arch = get_arch(aid)
        for shape in SHAPES.values():
            ok, reason = cell_is_applicable(arch, shape)
            if ok or include_skipped:
                out.append((aid, shape.name, ok, reason))
    return out
