"""Model assembly for every family of the config pool: the dense/GQA
decoder, the MoE decoder, the Mamba-2 SSM stack, the RG-LRU +
local-attention hybrid, the encoder-only audio backbone and the M-RoPE
vision-language backbone (the port of ``repro/models/transformer.py``).

Parameters keep the reference's layout: per-layer weights stacked on a
leading layer axis per layer kind, ``params["blocks"][kind][name]`` of
shape ``(L_kind, ...)``.  Caches keep the reference's leaves: attention
``(L, B, C, Hkv, hd)`` with per-slot positions in ``cache["pos"]``; SSM
``conv`` ``(L, B, K-1, d_inner+2N)`` in the model dtype and ``state``
``(L, B, H, P, N)`` in float32; recurrent ``conv`` ``(L, B, K-1, W)`` in
the model dtype and ``h`` ``(L, B, W)`` in float32.  The layer stack runs
as a Python loop over ``layers(cfg)`` (eager PyTorch has no ``scan`` to
compile).  A full-sequence layer of any kind is ``layer_fwd`` and its
states land in the cache through ``place_states``: the prefill, the train
forward, recovery (``core/kv_reconstruct.py``), the pipeline belt and the
dry run all walk the layers this way.

Entry points:
  * ``forward(..., mode="train")``   -> (logits (B,S,V) f32, aux)
  * ``forward(..., mode="prefill")`` -> (last-token logits (B,V) f32, cache)
  * ``decode_step(...)``             -> (logits (B,V) f32, cache)

``decode_step`` is zero-copy: each attention layer only reads its cache
slice and the current token's K/V row joins the softmax in the decode
kernel; after the layer loop one in-place write puts every layer's row at
``pos % C``.  Its attention layers run their RMSNorms (the second with the
residual add before it) and their split-half RoPE of q and k as the fused
ops ``ops.rms_norm`` and ``ops.rope_qk``, as does its final norm: on the
card one kernel each where the plain composition launched nine to
seventeen, the same arithmetic on the CPU.  Prefill, training and the SSM
and recurrent layers keep the plain composition.  SSM and recurrent
layers write their new conv window and state into their cache slices in
place, and a ``(B,)`` int32 ``pos`` is advanced in place.  The cache
passed in is updated in place — the analogue of the reference's donated
cache — and returned, so a CUDA graph captured over the step goes on
reading and writing the same storage.

MoE layers (``moe``) are attention layers whose FFN is ``moe.moe_mlp``:
the capacity path in full-sequence forwards, the dropless path in decode;
they fill the ``attn`` cache stack with the attention layers, in layer
order.  A model with no capacity (granite-4.0-h's) takes the MoE's sorted
path in full-sequence forwards, which drops nothing.

granite-4.0-h (a ``hybrid`` of ``ssm`` and ``moe`` layers): each SSM
layer is the Mamba-2 block (its mixer with a conv bias) followed by a
second norm and the MoE FFN (``ssm_layer_fwd``, ``ssm_layer_step``); its
attention layers have no position embedding (``use_rope`` False) and
score at ``attention_multiplier``; every sublayer's output joins the
residual times ``residual_multiplier``, the embedding is multiplied by
``embedding_multiplier`` and the logits divided by ``logits_scaling``.
Each of these is no operation at its default, so the other models'
steps launch what they did.  The audio family normalises with LayerNorm (``{scale, bias}``
leaves), attends non-causally and has no decode step.  M-RoPE models take
``(B, S, 3)`` (t, h, w) positions, and every model may take ``embeds``
(B, S, D) in place of tokens (the stubbed audio and vision frontends).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.context import (constrain, fold_rows, project,
                                             unfold_rows)
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba2, moe, rglru
from repro_torch.models.layers import (_ACTS, apply_mrope, apply_rope,
                                       dense_init, embed_init,
                                       kept_rope_freqs, layer_norm,
                                       residual_scaled, rms_norm)

Params = Dict[str, Any]
Cache = Dict[str, Any]

_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "float16": torch.float16}


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    return _TORCH_DTYPES[cfg.dtype]


def kind_counts(cfg: ArchConfig) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for k in cfg.layer_kinds():
        counts[k] = counts.get(k, 0) + 1
    return counts


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _norm_init(cfg: ArchConfig, L: int, dtype, device):
    """Stacked pre-norm weights: LayerNorm ``{scale, bias}`` for the audio
    family, an RMSNorm scale otherwise (``L`` None: one unstacked norm)."""
    shape = (cfg.d_model,) if L is None else (L, cfg.d_model)
    ones = torch.ones(shape, dtype=dtype, device=device)
    if cfg.family == "audio":
        return {"scale": ones,
                "bias": torch.zeros(shape, dtype=dtype, device=device)}
    return ones


def apply_norm(cfg: ArchConfig, w, x):
    if cfg.family == "audio":
        return layer_norm(w, x, cfg.norm_eps)
    return rms_norm(w, x, cfg.norm_eps)


def _init_attn_layers(gen: torch.Generator, cfg: ArchConfig, L: int,
                      dtype, device, mlp_init=None) -> Params:
    """Attention layers; ``mlp_init`` makes their FFN (the dense MLP by
    default, the MoE FFN for ``moe`` layers)."""
    D, hd = cfg.d_model, cfg.resolved_head_dim
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads

    def dense(*shape):
        return dense_init(gen, shape, dtype, device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    blk: Params = {
        "ln1": _norm_init(cfg, L, dtype, device), "wq": dense(L, D, Hq * hd),
        "wk": dense(L, D, Hkv * hd), "wv": dense(L, D, Hkv * hd),
        "wo": dense(L, Hq * hd, D), "ln2": _norm_init(cfg, L, dtype, device),
        "mlp": (mlp_init or _init_mlp)(gen, cfg, L, dtype, device),
    }
    if cfg.qkv_bias:
        blk.update(bq=zeros(L, Hq * hd), bk=zeros(L, Hkv * hd),
                   bv=zeros(L, Hkv * hd))
    if cfg.qk_norm:
        blk.update(q_norm=ones(L, hd), k_norm=ones(L, hd))
    return blk


def _init_mlp(gen: torch.Generator, cfg: ArchConfig, L: int, dtype,
              device) -> Params:
    D, F = cfg.d_model, cfg.d_ff
    if cfg.gated_mlp:
        names = (("w_gate", D, F), ("w_up", D, F), ("w_down", F, D))
    else:
        names = (("w_up", D, F), ("w_down", F, D))
    return {n: dense_init(gen, (L, a, b), dtype, device)
            for n, a, b in names}


def _init_moe_layers(gen: torch.Generator, cfg: ArchConfig, L: int, dtype,
                     device) -> Params:
    return _init_attn_layers(gen, cfg, L, dtype, device,
                             mlp_init=moe.init_moe_mlp)


def _init_rec_layers(gen: torch.Generator, cfg: ArchConfig, L: int, dtype,
                     device) -> Params:
    return {"ln1": _norm_init(cfg, L, dtype, device),
            "rec": rglru.init_rec_block(gen, cfg, L, dtype, device),
            "ln2": _norm_init(cfg, L, dtype, device),
            "mlp": _init_mlp(gen, cfg, L, dtype, device)}


def _init_ssm_layers(gen: torch.Generator, cfg: ArchConfig, L: int, dtype,
                     device) -> Params:
    """Mamba-2 blocks; in a model with experts (granite-4.0-h) each is
    followed by a second norm and the MoE FFN (``ln2``, ``mlp``)."""
    blk = mamba2.init_ssm_block(gen, cfg, L, dtype, device)
    if cfg.n_experts:
        blk.update(ln2=_norm_init(cfg, L, dtype, device),
                   mlp=moe.init_moe_mlp(gen, cfg, L, dtype, device))
    return blk


_LAYER_INIT = {"attn": _init_attn_layers, "moe": _init_moe_layers,
               "ssm": _init_ssm_layers, "rec": _init_rec_layers}


def init_params(cfg: ArchConfig, gen: torch.Generator, dtype=None,
                device="cuda") -> Params:
    """Random weights from ``gen`` (a generator on ``device``)."""
    dtype = dtype or torch_dtype(cfg)
    D, V = cfg.d_model, cfg.padded_vocab
    params: Params = {"embed": embed_init(gen, (V, D), dtype, device)}
    params["blocks"] = {kind: _LAYER_INIT[kind](gen, cfg, n, dtype, device)
                        for kind, n in kind_counts(cfg).items()}
    params["final_norm"] = _norm_init(cfg, None, dtype, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (D, V), dtype, device)
    return params


def layer_params(stacked: Params, i: int) -> Params:
    """Layer ``i``'s view of the stacked per-layer params."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------

def attn_cache_capacity(cfg: ArchConfig, max_len: int) -> int:
    """Ring-buffer capacity: the window for local attention, else max_len."""
    if cfg.attn_window > 0:
        return min(max_len, cfg.attn_window)
    return max_len


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> Cache:
    dtype = dtype or torch_dtype(cfg)
    counts = kind_counts(cfg)
    cache: Cache = {"pos": torch.zeros((), dtype=torch.int32, device=device)}
    n_attnlike = counts.get("attn", 0) + counts.get("moe", 0)
    if n_attnlike:
        C = attn_cache_capacity(cfg, max_len)
        shape = (n_attnlike, batch, C, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        cache["attn"] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                         "v": torch.zeros(shape, dtype=dtype, device=device)}
    if "ssm" in counts:
        L = counts["ssm"]
        ch = cfg.d_inner + 2 * cfg.ssm_state
        cache["ssm"] = {
            "conv": torch.zeros((L, batch, cfg.ssm_conv - 1, ch), dtype=dtype,
                                device=device),
            "state": torch.zeros((L, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                                  cfg.ssm_state), dtype=torch.float32,
                                 device=device)}
    if "rec" in counts:
        L, W = counts["rec"], cfg.lru_width or cfg.d_model
        cache["rec"] = {
            "conv": torch.zeros((L, batch, cfg.ssm_conv - 1, W), dtype=dtype,
                                device=device),
            "h": torch.zeros((L, batch, W), dtype=torch.float32,
                             device=device)}
    return cache


# ---------------------------------------------------------------------------
# Per-layer forwards
# ---------------------------------------------------------------------------

def _apply_mlp(cfg, p, x):
    act = _ACTS[cfg.act]
    if cfg.gated_mlp:
        h = constrain(act(project(x, p["w_gate"])) * project(x, p["w_up"]),
                      "ffh")
    else:
        h = constrain(act(project(x, p["w_up"])), "ffh")
    return project(h, p["w_down"])


def _ffn(cfg, p, x, *, dropless: bool = False):
    """The layer's FFN: (y, aux) — the MoE FFN (capacity path, or dropless
    in decode) where the layer has a router, else the dense MLP with aux
    None."""
    if "router" in p:
        return moe.moe_mlp(cfg, p, x, _ACTS[cfg.act], dropless=dropless)
    return _apply_mlp(cfg, p, x), None


def attn_out_ffn(cfg, p, x, o, *, dropless: bool = False):
    """The rest of an attention layer after its attention output o (B, S,
    Hq, hd): the output projection into the residual, the second norm and
    the FFN.  Returns (x, aux)."""
    x = constrain(x + residual_scaled(
        cfg, project(o.reshape(*x.shape[:2], -1), p["wo"])), "act")
    y, aux = _ffn(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x),
                  dropless=dropless)
    return constrain(x + residual_scaled(cfg, y), "act"), aux


def _project_q(cfg, p, h):
    """The query projection alone (B, S, Hq, hd), before rope."""
    B, S, _ = h.shape
    q = project(h, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(B, S, cfg.n_heads, cfg.resolved_head_dim)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
    return q


def _project_qkv(cfg, p, h):
    B, S, _ = h.shape
    hd = cfg.resolved_head_dim
    q = _project_q(cfg, p, h)
    k = project(h, p["wk"])
    v = project(h, p["wv"])
    if cfg.qkv_bias:
        k = k + p["bk"]
        v = v + p["bv"]
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    return q, k, v


def rope(cfg, x, positions):
    """RoPE, or M-RoPE with (B, S, 3) positions for an M-RoPE model; x
    itself for a model without position embedding (NoPE)."""
    if not cfg.use_rope:
        return x
    if cfg.mrope:
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(x, positions, cfg.rope_theta)


def attn_qkv(cfg, p, x, positions, *, kv: bool = True):
    """The pre-attention half of an attention layer over x (B, S, D): the
    first norm, the projections (with their biases and qk-norm) and RoPE.
    Returns the roped (q, k, v), (B, S, H, hd) each.  ``kv`` False: q
    alone, with no K/V projection, as (q, None, None) (the Q-only
    recompute of a layer whose K/V survived)."""
    h = apply_norm(cfg, p["ln1"], x)
    if not kv:
        q = _project_q(cfg, p, h)
        return constrain(rope(cfg, q, positions), "heads"), None, None
    q, k, v = _project_qkv(cfg, p, h)
    return (constrain(rope(cfg, q, positions), "heads"),
            constrain(rope(cfg, k, positions), "heads"),
            constrain(v, "heads"))


def attend(cfg, q, k, v, *, q_offset: int = 0):
    """Full-sequence attention (the flash kernel) at the config's
    causality, window and score scale; keys from position 0, queries from
    ``q_offset``."""
    return attn_lib.attention(q, k, v, causal=cfg.causal,
                              window=cfg.attn_window, q_offset=q_offset,
                              scale=attn_scale(cfg))


def attn_layer_fwd(cfg, p, x, positions):
    """Full-sequence attention layer: ``attn_qkv``, ``attend`` and
    ``attn_out_ffn`` (an MoE layer's FFN takes the capacity path).
    Returns (x, (k, v), aux) with the roped k/v (B, S, Hkv, hd) and the
    MoE load balance loss (None for a dense FFN)."""
    q, k, v = attn_qkv(cfg, p, x, positions)
    x, aux = attn_out_ffn(cfg, p, x, attend(cfg, q, k, v))
    return x, (k, v), aux


def attn_scale(cfg) -> Optional[float]:
    """The score scale: ``cfg.attention_multiplier``, or None for the
    kernels' head_dim ** -0.5."""
    return cfg.attention_multiplier or None


def _place_kv(dst, kv, *, clear: bool = False) -> None:
    """Write a prompt's k or v (B, S, Hkv, hd) into a cache slice (B, cap,
    Hkv, hd), zeroed already unless ``clear`` asks to zero the slots past
    the prompt.  A ring buffer smaller than the prompt keeps the tail,
    rolled so that slot j holds the position p with p % cap == j (decode
    writes at pos % cap, so the oldest entry is overwritten)."""
    S, cap = kv.shape[1], dst.shape[1]
    if cap >= S:
        dst[:, :S] = kv
        if clear:
            dst[:, S:].zero_()
    else:
        shift = (S - cap) % cap
        dst.copy_(torch.roll(kv[:, S - cap:], shift, dims=1))


def attn_layer_step(cfg, p, x, positions, k_cache, v_cache, valid_old,
                    slot_mask=None, *, fused: bool = False, inv_freq=None):
    """Zero-copy single-token step. x: (B, 1, D); caches (B, C, Hkv, hd),
    only read; positions: (B, 1), or (B, 1, 3) for M-RoPE; valid_old: (B,)
    int32 cache rows each slot attends (its length, at most C);
    slot_mask: (B, C) bool, a ring-buffered (windowed) cache's valid slots
    (``_decode_cache_view`` makes both once a step).  Returns (x, k_row,
    v_row): the caller writes the (B, Hkv, hd) rows once, after the layer
    loop.  An MoE layer's FFN takes the dropless path.

    ``fused``: the norms run as ``ops.rms_norm``, the second with the
    residual add of the attention output folded in; with ``inv_freq``
    (hd/2,) float32, q and k are roped by one ``ops.rope_qk`` at
    ``positions`` given as (B,) int32.  The arithmetic is the same."""
    if fused:
        h = ops.rms_norm(x, p["ln1"], cfg.norm_eps)
    else:
        h = apply_norm(cfg, p["ln1"], x)
    q, k, v = _project_qkv(cfg, p, h)
    if inv_freq is not None:
        q, k = ops.rope_qk(q, k, positions, inv_freq)
    else:
        q = rope(cfg, q, positions)
        k = rope(cfg, k, positions)
    o = attn_lib.decode_attention_merged(q, k_cache, v_cache, valid_old,
                                         k, v, kv_slot_mask=slot_mask,
                                         scale=attn_scale(cfg))
    if not fused:
        x, _ = attn_out_ffn(cfg, p, x, o, dropless=True)
        return x, k[:, 0], v[:, 0]
    x, h2 = ops.rms_norm(residual_scaled(
        cfg, project(o.reshape(*x.shape[:2], -1), p["wo"])),
        p["ln2"], cfg.norm_eps, residual=x)
    y, _ = _ffn(cfg, p["mlp"], h2, dropless=True)
    return x + residual_scaled(cfg, y), k[:, 0], v[:, 0]


def _decode_cache_view(cfg, cache_len, C: int):
    """(valid_old, slot_mask) of a decode step over attention caches of
    capacity C at per-slot lengths ``cache_len`` (B,) int32: the cache rows
    each slot attends, at most C, and for a ring-buffered (windowed) cache
    the (B, C) bool mask of valid slots, which leaves out the slot the new
    row will overwrite (once the ring is full it holds position pos - C,
    one step outside the window); None without a window.  Every attention
    layer of one cache stack has the same C, so a step makes them once."""
    valid_old = torch.clamp(cache_len, max=C)
    if cfg.attn_window <= 0:
        return valid_old, None
    j = torch.arange(C, device=cache_len.device)[None, :]
    p_len = cache_len[:, None]
    return valid_old, (j < p_len) & ((p_len < C) | (j != p_len % C))


def ssm_layer_fwd(cfg, p, x, *, conv_state=None, ssm_state=None):
    """Full-sequence SSM layer: the Mamba-2 block (``mamba2.ssm_block_fwd``:
    pre-norm, mixer, scaled residual), then, where the layer has one
    (granite-4.0-h), the second norm and the FFN into the scaled residual:
    the MoE's sorted path, which drops nothing.  Returns (x, (conv_state,
    ssm_state))."""
    x, states = mamba2.ssm_block_fwd(cfg, p, x, conv_state=conv_state,
                                     ssm_state=ssm_state)
    if "mlp" in p:
        y, _ = _ffn(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
        x = constrain(x + residual_scaled(cfg, y), "act")
    return x, states


def ssm_layer_step(cfg, p, x, conv_state, ssm_state):
    """Single-token SSM layer. x: (B, 1, D); the FFN, where the layer has
    one, on the dropless decode path.  Returns (x, conv_state,
    ssm_state): a new conv state tensor, and ``ssm_state`` itself, updated
    in place."""
    y, (conv_s, state) = mamba2.ssm_block_step(cfg, p, x[:, 0], conv_state,
                                               ssm_state)
    x = y[:, None]
    if "mlp" in p:
        f, _ = _ffn(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x),
                    dropless=True)
        x = x + residual_scaled(cfg, f)
    return x, conv_s, state


def rec_layer_fwd(cfg, p, x, *, conv_state=None, h0=None):
    """Full-sequence recurrent layer (its scan runs the RG-LRU kernel).
    Returns (x, (conv_state, h_last))."""
    h = apply_norm(cfg, p["ln1"], x)
    y, state = rglru.rec_block_fwd(cfg, p["rec"], h, conv_state=conv_state,
                                   h0=h0)
    x = constrain(x + y, "act")
    h2 = apply_norm(cfg, p["ln2"], x)
    return constrain(x + _apply_mlp(cfg, p["mlp"], h2), "act"), state


def rec_layer_step(cfg, p, x, conv_state, h):
    """Single-token recurrent layer. x: (B, 1, D); h: (B, W) float32.
    Returns (x, conv_state, h_new)."""
    hin = apply_norm(cfg, p["ln1"], x)
    y, (conv_s, h_new) = rglru.rec_block_step(cfg, p["rec"], hin[:, 0],
                                              conv_state, h)
    x = x + y[:, None]
    h2 = apply_norm(cfg, p["ln2"], x)
    return x + _apply_mlp(cfg, p["mlp"], h2), conv_s, h_new


def layer_fwd(cfg, kind, p, x, positions):
    """One full-sequence layer of kind ``kind`` over x (B, S, D): (x,
    states, aux).  ``states`` are the layer's new cache leaves in the
    cache's leaf order (attention and MoE layers: the roped k, v (B, S,
    Hkv, hd); SSM: conv, state; recurrent: conv, h), which
    ``place_states`` writes; ``aux`` is an attention layer's MoE load
    balance loss, else None."""
    if kind in ("attn", "moe"):
        return attn_layer_fwd(cfg, p, x, positions)
    fwd = ssm_layer_fwd if kind == "ssm" else rec_layer_fwd
    x, states = fwd(cfg, p, x)
    return x, states, None


def place_states(cache, layer, states, rows=None, *,
                 clear: bool = False) -> None:
    """Write ``layer_fwd``'s ``states`` of ``layer`` (an entry of
    ``layers``) into ``cache`` in place, at ``rows`` of its batch (all
    when None): K/V as a prefill lays them out (``_place_kv``; ``clear``
    zeroes the slots past the sequence), SSM and recurrent states whole.
    ``cache`` may be a view of some slots of a larger one."""
    kind, i, a = layer
    at = a if a >= 0 else i
    if rows is not None:
        at = (at, rows)
    if a >= 0:
        for leaf, t in zip(("k", "v"), states):
            _place_kv(cache["attn"][leaf][at], t, clear=clear)
    else:       # leaves in the order the layer returns them
        for dst, t in zip(cache[kind].values(), states):
            dst[at].copy_(t)


# ---------------------------------------------------------------------------
# Full-model forward
# ---------------------------------------------------------------------------

def _embed_scaled(cfg, x):
    """Embedded tokens times ``cfg.embedding_multiplier`` (no operation
    where it is 1)."""
    em = cfg.embedding_multiplier
    return x if em == 1.0 else x * em


def embed_tokens(cfg, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x (B,S,D), positions): ``batch["embeds"]`` (B, S, D) or the
    embedded ``batch["tokens"]``; ``batch["positions"]`` ((B, S), or (B,
    S, 3) for M-RoPE) or 0..S-1 per row."""
    if "embeds" in batch:
        x = batch["embeds"]
    else:
        # the embedding op, not indexing: its backward on DTensors
        # (a train step sharded over a process group) has a sharding rule
        # in every torch version the port meets, where index_put's fails
        # on a batch-split gradient in torch 2.11
        x = torch.nn.functional.embedding(batch["tokens"], params["embed"])
        x = _embed_scaled(cfg, x)
    if "positions" in batch:
        return constrain(x, "act"), batch["positions"]
    B, S = x.shape[:2]
    return constrain(x, "act"), torch.arange(S, device=x.device)[
        None, :].expand(B, S)


class _Float32Product(torch.autograd.Function):
    """x @ head with float32 output from bf16 operands (``torch.mm`` with
    ``out_dtype``, which autograd cannot differentiate).  The backward
    rounds the float32 logits' gradient to the operands' dtype and runs
    the two bf16 products of the matmul's gradient."""

    @staticmethod
    def forward(ctx, x2, head):
        ctx.save_for_backward(x2, head)
        return torch.mm(x2, head, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, dy):
        x2, head = ctx.saved_tensors
        dy = dy.to(x2.dtype)
        return dy @ head.T, x2.T @ dy


def unembed(cfg, params, x) -> torch.Tensor:
    """float32 logits over the padded vocab, as the reference's
    ``preferred_element_type`` gives them.  On the card a bf16 product
    writes float32 directly (float32 accumulation, no float32 copy of the
    (V, D) embedding); on the CPU, which has no such product, the operands
    are upcast.  A meta tensor (the dry run's) stands for the card."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if x.device.type != "cpu" and x.dtype != torch.float32:
        y = _Float32Product.apply(fold_rows(x), head)
        y = constrain(unfold_rows(y, x), "logits")
    else:
        y = constrain(project(x.float(), head.float()), "logits")
    # granite-4.0-h divides its logits (no operation where the scale is 1)
    return y if cfg.logits_scaling == 1.0 else y / cfg.logits_scaling


def layers(cfg: ArchConfig) -> List[Tuple[str, int, int]]:
    """(kind, index in that kind's stack, index in the ``attn`` cache
    stack or -1) of every layer, in model order.  attn and moe layers
    share the ``attn`` cache stack."""
    out: List[Tuple[str, int, int]] = []
    seen: Dict[str, int] = {}
    attnlike = 0
    for kind in cfg.layer_kinds():
        i = seen.get(kind, 0)
        seen[kind] = i + 1
        if kind in ("attn", "moe"):
            out.append((kind, i, attnlike))
            attnlike += 1
        else:
            out.append((kind, i, -1))
    return out


def _unstack(stacked: Params, n: int) -> List[Params]:
    """Every layer's view of the stacked per-layer params, from one
    ``unbind`` per leaf: under autograd each leaf's gradient is then one
    stack of the layers' gradients, where per-layer indexing would add a
    zero-filled copy of the whole leaf for every layer."""
    per = [dict() for _ in range(n)]
    for k, v in stacked.items():
        parts = _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
        for d, part in zip(per, parts):
            d[k] = part
    return per


def _train_layer(cfg, kind, p, x, positions):
    """One layer of a train forward: (x, aux), aux a float32 scalar (0
    for a layer without a router)."""
    x, _, aux = layer_fwd(cfg, kind, p, x, positions)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def forward(cfg: ArchConfig, params: Params, batch: Dict, *,
            mode: str = "train", max_len: Optional[int] = None,
            last_index=None, remat: bool = False) -> Tuple[torch.Tensor, Any]:
    """Full-sequence forward.

    mode="train":   returns (logits (B,S,V) f32, aux_loss scalar: the MoE
                    layers' load-balance losses summed)
    mode="prefill": returns (last logits (B,V) f32, cache)

    ``remat`` (train mode): each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant), so its activations are
    recomputed in the backward instead of kept, as the reference's
    ``jax.checkpoint`` of its layer body does.  The reference's ``unroll``
    is a ``lax.scan`` knob with no counterpart in an eager layer loop and
    is not taken.

    ``batch``: {"tokens": (B, S)} or {"embeds": (B, S, D)}, optionally
    with "positions" ((B, S), or (B, S, 3) for M-RoPE).

    ``last_index`` (B,) int, prefill only: per-row index of the true last
    prompt token of right-padded (bucketed) prompts.  Logits are gathered
    there and ``cache["pos"]`` is ``last_index + 1``, so decode masks the
    pad K/V.  Only valid for pure attention with a full-length cache: an
    SSM or recurrent state would take in the pad tokens, and MoE capacity
    couples the rows (callers gate on that).
    """
    if mode not in ("train", "prefill"):
        raise ValueError(f"mode {mode!r}")
    x, positions = embed_tokens(cfg, params, batch)
    B, S = x.shape[:2]
    if mode == "train":
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        per_layer = {kind: _unstack(params["blocks"][kind], n)
                     for kind, n in kind_counts(cfg).items()}
        for kind, i, _ in layers(cfg):
            p = per_layer[kind][i]
            if remat:
                x, aux = torch.utils.checkpoint.checkpoint(
                    _train_layer, cfg, kind, p, x, positions,
                    use_reentrant=False)
            else:
                x, aux = _train_layer(cfg, kind, p, x, positions)
            aux_total = aux_total + aux
        x = apply_norm(cfg, params["final_norm"], x)
        return unembed(cfg, params, x), aux_total

    # the prompt's states, written layer by layer (pos is set at the end)
    cache: Cache = init_cache(cfg, B, max_len or S, x.dtype, x.device)
    for layer in layers(cfg):
        kind, i, _ = layer
        p = layer_params(params["blocks"][kind], i)
        x, states, _ = layer_fwd(cfg, kind, p, x, positions)
        place_states(cache, layer, states)
    x = apply_norm(cfg, params["final_norm"], x)

    if last_index is not None:
        li = torch.as_tensor(last_index, dtype=torch.int32, device=x.device)
        x_last = x[torch.arange(B, device=x.device), li.long()]
        logits = unembed(cfg, params, x_last[:, None, :])[:, 0, :]
        pos = li + 1
    else:
        logits = unembed(cfg, params, x[:, -1:, :])[:, 0, :]
        pos = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits, {**cache, "pos": pos}


def decode_step(cfg: ArchConfig, params: Params, batch: Dict,
                cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """One autoregressive step; updates ``cache`` in place.

    batch: {"tokens": (B,) int} or {"embeds": (B, 1, D)}, optionally with
    "positions" ((B, 1), or (B, 1, 3) for M-RoPE; else ``cache["pos"]``).
    Returns (logits (B, V) f32, cache) with ``pos`` advanced by one: in
    place when it is a ``(B,)`` int32 tensor (the serving batcher's, and
    every prefill's), else replaced by one.  An encoder-only model has no
    decode step and raises.
    """
    if not cfg.has_decode:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    if "embeds" in batch:
        x = batch["embeds"]
    else:
        x = _embed_scaled(cfg, params["embed"][batch["tokens"].reshape(-1)][
            :, None, :])
    B = x.shape[0]
    pos = cache["pos"]
    if pos.dim() == 0:
        pos = pos.expand(B)
    pos = pos.to(torch.int32).contiguous()
    positions = batch["positions"] if "positions" in batch else pos[:, None]
    # the attention layers' norms and RoPE as the fused ops: RMSNorm (not
    # the audio family's LayerNorm), on one device (a DTensor, the dry
    # run's, takes the plain ops); RoPE when split-half (not M-RoPE)
    fused = (cfg.family != "audio" and "attn" in cache
             and type(x).__name__ != "DTensor")
    inv_freq = None
    if "attn" in cache:
        valid_old, slot_mask = _decode_cache_view(
            cfg, pos, cache["attn"]["k"].shape[2])
        if fused and cfg.use_rope and not cfg.mrope:
            inv_freq = kept_rope_freqs(cfg.resolved_head_dim,
                                       cfg.rope_theta, x.device)
            positions = positions.reshape(B).to(torch.int32).contiguous()
    k_rows, v_rows = [], []
    for kind, i, a in layers(cfg):
        p = layer_params(params["blocks"][kind], i)
        if a >= 0:
            x, kn, vn = attn_layer_step(cfg, p, x, positions,
                                        cache["attn"]["k"][a],
                                        cache["attn"]["v"][a], valid_old,
                                        slot_mask, fused=fused,
                                        inv_freq=inv_freq)
            k_rows.append(kn)
            v_rows.append(vn)
        elif kind == "ssm":
            conv, state = cache["ssm"]["conv"][i], cache["ssm"]["state"][i]
            # the state is updated in place (``ops.ssm_step``)
            x, conv_new, _ = ssm_layer_step(cfg, p, x, conv, state)
            conv.copy_(conv_new)
        else:
            conv, h = cache["rec"]["conv"][i], cache["rec"]["h"][i]
            x, conv_new, h_new = rec_layer_step(cfg, p, x, conv, h)
            conv.copy_(conv_new)
            h.copy_(h_new)
    if k_rows:
        # the one post-loop row write of every layer, in place at pos % C
        kc, vc = cache["attn"]["k"], cache["attn"]["v"]
        slot = (pos % kc.shape[2]).long()
        bidx = torch.arange(B, device=x.device)
        kc[:, bidx, slot] = torch.stack(k_rows)
        vc[:, bidx, slot] = torch.stack(v_rows)
    if fused:
        x = ops.rms_norm(x, params["final_norm"], cfg.norm_eps)
    else:
        x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params, x)[:, 0, :]
    if cache["pos"] is pos:
        pos.add_(1)
    else:
        cache["pos"] = pos + 1
    return logits, cache
