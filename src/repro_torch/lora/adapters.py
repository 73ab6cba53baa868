"""LoRA adapters over the stacked-parameter model (the port of
``repro/lora/adapters.py``).

Adapters target the attention projections (wq, wk, wv, wo) of every
attention-bearing (``attn`` or ``moe``) layer, the paper's merged-LoRA serving path (§4.3.2):
``W' = W + (alpha/r) * A @ B``.  Merging and unmerging are inverses up to
float accumulation and the rounding of W's dtype.  Both run through the
LoRA-merge kernel for CUDA tensors and its plain version for CPU tensors
(``repro_torch.kernels.lora_merge``); merging returns new tensors and
leaves the input params untouched.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init

TARGETS = ("wq", "wk", "wv", "wo")


@dataclass
class LoRAAdapter:
    name: str
    rank: int
    alpha: float
    # blocks[kind][target] = {"A": (L, d_in, r), "B": (L, r, d_out)}
    blocks: Dict[str, Dict[str, Dict[str, torch.Tensor]]]

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _attn_dims(cfg: ArchConfig) -> Dict[str, Tuple[int, int]]:
    D, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": (D, cfg.n_heads * hd),
        "wk": (D, cfg.n_kv_heads * hd),
        "wv": (D, cfg.n_kv_heads * hd),
        "wo": (cfg.n_heads * hd, D),
    }


def init_lora(gen: torch.Generator, cfg: ArchConfig, rank: int, *,
              alpha: float = None, name: str = "adapter",
              dtype=torch.float32, device="cuda") -> LoRAAdapter:
    """A ~ truncated N(0, 1/d_in), B = 0 (standard LoRA init), for the
    attention projections of every ``attn`` and ``moe`` layer, under the
    kind's own stack (``blocks["attn"]``, ``blocks["moe"]``)."""
    alpha = alpha if alpha is not None else 2.0 * rank
    blocks = {}
    for kind in ("attn", "moe"):
        L = sum(1 for k in cfg.layer_kinds() if k == kind)
        if not L:
            continue
        blocks[kind] = {
            t: {"A": dense_init(gen, (L, din, rank), dtype, device),
                "B": torch.zeros((L, rank, dout), dtype=dtype,
                                 device=device)}
            for t, (din, dout) in _attn_dims(cfg).items()}
    return LoRAAdapter(name, rank, alpha, blocks)


def randomize_lora(gen: torch.Generator, adapter: LoRAAdapter) -> LoRAAdapter:
    """Give B non-zero values (tests / distinct-adapter simulations)."""
    blocks = {}
    for kind, tgts in adapter.blocks.items():
        blocks[kind] = {}
        for t, ab in tgts.items():
            b = ab["B"]
            noise = torch.randn(b.shape, dtype=torch.float32, device=b.device,
                                generator=gen)
            blocks[kind][t] = {"A": ab["A"], "B": (noise * 0.02).to(b.dtype)}
    return LoRAAdapter(adapter.name, adapter.rank, adapter.alpha, blocks)


def _apply(params, adapter: LoRAAdapter, sign: float):
    new = dict(params)
    new["blocks"] = dict(params["blocks"])
    for kind, tgts in adapter.blocks.items():
        blk = dict(new["blocks"][kind])
        for t, ab in tgts.items():
            blk[t] = ops.lora_merge(blk[t], ab["A"], ab["B"],
                                    sign * adapter.scale)
        new["blocks"][kind] = blk
    return new


def merge_lora(params, adapter: LoRAAdapter):
    """W' = W + scale * A@B on every target projection (new tensors for
    the targets; every other leaf is shared with ``params``)."""
    return _apply(params, adapter, +1.0)


def unmerge_lora(params, adapter: LoRAAdapter):
    return _apply(params, adapter, -1.0)


def lora_bytes(cfg: ArchConfig, rank: int, dtype_bytes: int = 2) -> int:
    """Bytes of one adapter: rank x (Din + Dout) per target projection of
    every attention (and MoE) layer."""
    dims = _attn_dims(cfg)
    n_attn = sum(1 for k in cfg.layer_kinds() if k in ("attn", "moe"))
    n = sum(rank * (din + dout) for din, dout in dims.values())
    return n * n_attn * dtype_bytes
