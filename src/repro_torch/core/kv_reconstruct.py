"""KV-cache and recurrent-state reconstruction after a crash (paper §4.4.2;
the port of ``repro/core/kv_reconstruct.py``).

Given the merged token sequence processed so far (prompt + generated) and
a per-layer "has state" mask, rebuild the missing per-layer caches:

  * attention and MoE layers WITH K/V: only Q is recomputed over the
    sequence and attends against the surviving cache — exact, since the
    cached K/V are what a recompute would give; an MoE layer's FFN runs
    the capacity path over the rebuilt tokens, as its prefill did.  Causal attention from key 0 over the
    cache's first S rows: the flash kernel on the card, reading the cache
    through its strides; on a windowed layer the same kernel with the
    window (its plain version on the CPU is the reference's ring form,
    ``_windowed_ring_attention``);
  * attention layers WITH K/V in a *wrapped* ring (a windowed cache shorter
    than the sequence): the evicted positions cannot be reused, so the
    layer's activations are recomputed in full while the surviving ring is
    kept;
  * attention layers WITHOUT K/V: the layer runs in full and its K/V are
    written into its cache slice in place;
  * SSM and RG-LRU layers WITHOUT state: a full re-scan (the SSD or RG-LRU
    kernel) whose final state is written in place; layers WITH state are
    run for their activations and keep their state.

Every full layer is the model's own (``transformer.layer_fwd``, its states
written by ``transformer.place_states``), so the rebuild runs what the
prefill ran: a granite-4.0-h SSM layer's MoE FFN, an attention layer's
score scale.

Reconstruction stops at the deepest missing layer: every layer above it
kept its state.  The cache passed in is updated in place (the analogue of
the reference's functional update), so a view of a serving batcher's slots
is rebuilt where the batcher's captured decode graph reads it.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import transformer

STAT_KEYS = ("layers_recomputed", "kv_reused", "full_prefill",
             "window_recompute", "layers_skipped",
             # token-granular work: positions whose K/V were reused (Q
             # recomputed), and positions run through a full layer forward
             # (missing layers and wrapped-ring recomputes)
             "q_only_tokens", "prefill_tokens")


def reconstruct_cache(cfg: ArchConfig, params, batch: Dict, cache: Dict,
                      has_state: Sequence[bool],
                      max_len: Optional[int] = None
                      ) -> Tuple[Dict, Dict[str, int]]:
    """Rebuild the missing per-layer state of ``cache`` in place.
    ``has_state[i]`` is per *global* layer; ``batch`` carries the merged
    sequence {"tokens": (B, S)} or {"embeds": (B, S, D)} (with
    "positions" for M-RoPE).  Returns (cache, stats), stats counting
    the work done (the reference's keys and values); ``cache["pos"]``
    becomes S.  The rebuilt cache equals a fresh prefill's up to float
    rounding."""
    walk = transformer.layers(cfg)
    if len(has_state) != len(walk):
        raise ValueError(f"has_state has {len(has_state)} entries for "
                         f"{len(walk)} layers")
    x, positions = transformer.embed_tokens(cfg, params, batch)
    B, S = x.shape[:2]
    # a wrapped ring (a windowed cache shorter than the sequence) has lost
    # the evicted positions: a surviving ring stays (it is exact for
    # decode) and its layer's activations are recomputed in full
    wrapped = cfg.attn_window > 0 and \
        S > transformer.attn_cache_capacity(cfg, max_len or S)
    deepest_missing = max((i for i, h in enumerate(has_state) if not h),
                          default=-1)
    stats = {k: 0 for k in STAT_KEYS}
    for gi, layer in enumerate(walk):
        if gi > deepest_missing:
            stats["layers_skipped"] += len(walk) - gi
            break
        kind, ki, ai = layer
        p = transformer.layer_params(params["blocks"][kind], ki)
        if has_state[gi] and ai >= 0 and not wrapped:
            x = _q_only_layer(cfg, p, x, positions, cache["attn"]["k"][ai],
                              cache["attn"]["v"][ai])
            stats["kv_reused"] += 1
            stats["q_only_tokens"] += S
        else:
            x, states, _ = transformer.layer_fwd(cfg, kind, p, x, positions)
            if not has_state[gi]:
                transformer.place_states(cache, layer, states, clear=True)
                stats["full_prefill"] += 1
                stats["prefill_tokens"] += S
            elif ai >= 0:
                stats["window_recompute"] += 1
                stats["prefill_tokens"] += S
        stats["layers_recomputed"] += 1
    pos = cache["pos"]
    if isinstance(pos, torch.Tensor) and pos.shape == (B,) \
            and pos.dtype == torch.int32:
        pos.fill_(S)
    else:
        cache["pos"] = torch.full((B,), S, dtype=torch.int32,
                                  device=x.device)
    return cache, stats


def _q_only_layer(cfg, p, x, positions, kc, vc):
    """One attention layer whose K/V survived: Q alone is projected
    (``transformer.attn_qkv(kv=False)``) and attends the cache's first S
    rows, then the output projection and the FFN as in a full layer."""
    S = x.shape[1]
    q, _, _ = transformer.attn_qkv(cfg, p, x, positions, kv=False)
    if cfg.attn_window > 0 and not q.is_cuda:
        o = _windowed_ring_attention(cfg, q, kc, vc, S)
    else:
        # from key 0 (S <= cap on a windowed layer: slot j holds position
        # j), the flash kernel reading the cache's strides
        o = transformer.attend(cfg, q, kc[:, :S], vc[:, :S])
    return transformer.attn_out_ffn(cfg, p, x, o)[0]


def _windowed_ring_attention(cfg, q, kc, vc, S):
    """Attention of full-sequence Q against a ring-buffered local cache:
    the plain version of the windowed Q-only branch.

    The ring holds the last ``cap`` roped keys in rotated order; the query
    at position t attends keys with position in (t - window, t].  Each
    slot's position comes from S and the slot index, then is masked per
    query."""
    B, _, Hq, hd = q.shape
    cap, Hkv = kc.shape[1], kc.shape[2]
    S = q.shape[1]
    ring = _ring_slot_positions(S, cap, q.device)
    scale = transformer.attn_scale(cfg) or hd ** -0.5
    qf = (q.float() * scale).reshape(B, S, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bqkgd,bckd->bqkgc", qf, kc.float())
    q_pos = torch.arange(S, device=q.device)
    ok = (ring[None, :] <= q_pos[:, None]) & \
         (ring[None, :] > q_pos[:, None] - cfg.attn_window) & \
         (ring[None, :] >= 0)
    ok = ok[None, :, None, None, :]
    s = torch.where(ok, s, attn_lib.NEG_INF)
    p = torch.where(ok, torch.softmax(s, dim=-1), 0.0)
    o = torch.einsum("bqkgc,bckd->bqkgd", p, vc.float())
    return o.reshape(B, S, Hq, hd).to(q.dtype)


def _ring_slot_positions(S: int, cap: int, device=None) -> torch.Tensor:
    """Global position held by each ring slot after S writes (-1 if
    empty)."""
    slots = torch.arange(cap, device=device)
    if S >= cap:
        # slot j holds the largest p < S with p % cap == j
        return S - 1 - torch.remainder(S - 1 - slots, cap)
    return torch.where(slots < S, slots, -1)
