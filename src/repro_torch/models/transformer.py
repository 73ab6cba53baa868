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
as a Python loop over the runs of equal kinds (eager PyTorch has no
``scan`` to compile); a hybrid pattern such as ``rec, rec, attn`` becomes
several short runs.

Entry points:
  * ``forward(..., mode="train")``   -> (logits (B,S,V) f32, aux)
  * ``forward(..., mode="prefill")`` -> (last-token logits (B,V) f32, cache)
  * ``decode_step(...)``             -> (logits (B,V) f32, cache)

``decode_step`` is zero-copy: each attention layer only reads its cache
slice and the current token's K/V row joins the softmax in the decode
kernel; after the layer loop one in-place write puts every layer's row at
``pos % C``.  SSM and recurrent layers write their new conv window and
state into their cache slices in place, and a ``(B,)`` int32 ``pos`` is
advanced in place.  The cache passed in is updated in place — the analogue
of the reference's donated cache — and returned, so a CUDA graph captured
over the step goes on reading and writing the same storage.

MoE layers (``moe``) are attention layers whose FFN is ``moe.moe_mlp``:
the capacity path in full-sequence forwards, the dropless path in decode;
they fill the ``attn`` cache stack with the attention layers, in layer
order.  The audio family normalises with LayerNorm (``{scale, bias}``
leaves), attends non-causally and has no decode step.  M-RoPE models take
``(B, S, 3)`` (t, h, w) positions, and every model may take ``embeds``
(B, S, D) in place of tokens (the stubbed audio and vision frontends).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.context import constrain
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba2, moe, rglru
from repro_torch.models.layers import (_ACTS, apply_mrope, apply_rope,
                                       dense_init, embed_init, layer_norm,
                                       rms_norm)

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


def _apply_norm(cfg: ArchConfig, w, x):
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


_LAYER_INIT = {"attn": _init_attn_layers, "moe": _init_moe_layers,
               "ssm": mamba2.init_ssm_block, "rec": _init_rec_layers}


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
        h = constrain(act(x @ p["w_gate"]) * (x @ p["w_up"]), "ffh")
    else:
        h = constrain(act(x @ p["w_up"]), "ffh")
    return h @ p["w_down"]


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
    x = constrain(x + o.reshape(*x.shape[:2], -1) @ p["wo"], "act")
    y, aux = _ffn(cfg, p["mlp"], _apply_norm(cfg, p["ln2"], x),
                  dropless=dropless)
    return constrain(x + y, "act"), aux


def project_q(cfg, p, h):
    """The query projection alone (B, S, Hq, hd), before rope: what the
    Q-only recompute of a layer whose K/V survived needs."""
    B, S, _ = h.shape
    q = h @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(B, S, cfg.n_heads, cfg.resolved_head_dim)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
    return q


def _project_qkv(cfg, p, h):
    B, S, _ = h.shape
    hd = cfg.resolved_head_dim
    q = project_q(cfg, p, h)
    k = h @ p["wk"]
    v = h @ p["wv"]
    if cfg.qkv_bias:
        k = k + p["bk"]
        v = v + p["bv"]
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    return q, k, v


def rope(cfg, x, positions):
    """RoPE, or M-RoPE with (B, S, 3) positions for an M-RoPE model."""
    if cfg.mrope:
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(x, positions, cfg.rope_theta)


def attn_layer_fwd(cfg, p, x, positions, *, kv_write=None):
    """Full-sequence attention layer (prefill attention runs the flash
    kernel, causal or not as the config says; an MoE layer's FFN takes
    the capacity path).  Returns (x, (k, v), aux) with the roped k/v (B,
    S, Hkv, hd) that ``forward`` places into the cache and the MoE load
    balance loss (None for a dense FFN).

    ``kv_write`` (k_dst, v_dst): this layer's cache slices (B, cap, Hkv,
    hd), written in place with the roped k/v as a prefill lays them out
    (the ring's tail when the sequence is longer than the slice, zeros past
    a shorter one) — the reference's ``kv_write=cap``, which the full-layer
    recompute of ``core.kv_reconstruct`` uses."""
    h = _apply_norm(cfg, p["ln1"], x)
    q, k, v = _project_qkv(cfg, p, h)
    q = constrain(rope(cfg, q, positions), "heads")
    k = constrain(rope(cfg, k, positions), "heads")
    v = constrain(v, "heads")
    o = attn_lib.attention(q, k, v, causal=cfg.causal,
                           window=cfg.attn_window)
    if kv_write is not None:
        for dst, t in zip(kv_write, (k, v)):
            _place_kv(dst, t, dst.shape[1], clear=True)
    x, aux = attn_out_ffn(cfg, p, x, o)
    return x, (k, v), aux


def _place_kv(dst, kv, cap: int, *, clear: bool = False) -> None:
    """Write a prompt's k or v (B, S, Hkv, hd) into a cache slice (B, cap,
    Hkv, hd), zeroed already unless ``clear`` asks to zero the slots past
    the prompt.  A ring buffer smaller than the prompt keeps the tail,
    rolled so that slot j holds the position p with p % cap == j (decode
    writes at pos % cap, so the oldest entry is overwritten)."""
    S = kv.shape[1]
    if cap >= S:
        dst[:, :S] = kv
        if clear:
            dst[:, S:].zero_()
    else:
        shift = (S - cap) % cap
        dst.copy_(torch.roll(kv[:, S - cap:], shift, dims=1))


def attn_layer_step(cfg, p, x, positions, k_cache, v_cache, cache_len):
    """Zero-copy single-token step. x: (B, 1, D); caches (B, C, Hkv, hd),
    only read; positions: (B, 1), or (B, 1, 3) for M-RoPE; cache_len: (B,)
    per-slot valid lengths.  Returns (x, k_row, v_row): the caller writes
    the (B, Hkv, hd) rows once, after the layer loop.  A ring-buffered
    (windowed) cache masks the slot the new row will overwrite: once the
    ring is full it holds position pos - C, one step outside the window.
    An MoE layer's FFN takes the dropless path."""
    h = _apply_norm(cfg, p["ln1"], x)
    q, k, v = _project_qkv(cfg, p, h)
    q = rope(cfg, q, positions)
    k = rope(cfg, k, positions)
    C = k_cache.shape[1]
    valid_old = torch.clamp(cache_len, max=C)
    slot_mask = None
    if cfg.attn_window > 0:
        j = torch.arange(C, device=x.device)[None, :]
        p_len = cache_len[:, None]
        slot_mask = (j < p_len) & ((p_len < C) | (j != p_len % C))
    o = attn_lib.decode_attention_merged(q, k_cache, v_cache, valid_old,
                                         k, v, kv_slot_mask=slot_mask)
    x, _ = attn_out_ffn(cfg, p, x, o, dropless=True)
    return x, k[:, 0], v[:, 0]


def rec_layer_fwd(cfg, p, x, *, conv_state=None, h0=None):
    """Full-sequence recurrent layer (its scan runs the RG-LRU kernel).
    Returns (x, (conv_state, h_last))."""
    h = _apply_norm(cfg, p["ln1"], x)
    y, state = rglru.rec_block_fwd(cfg, p["rec"], h, conv_state=conv_state,
                                   h0=h0)
    x = constrain(x + y, "act")
    h2 = _apply_norm(cfg, p["ln2"], x)
    return constrain(x + _apply_mlp(cfg, p["mlp"], h2), "act"), state


def rec_layer_step(cfg, p, x, conv_state, h):
    """Single-token recurrent layer. x: (B, 1, D); h: (B, W) float32.
    Returns (x, conv_state, h_new)."""
    hin = _apply_norm(cfg, p["ln1"], x)
    y, (conv_s, h_new) = rglru.rec_block_step(cfg, p["rec"], hin[:, 0],
                                              conv_state, h)
    x = x + y[:, None]
    h2 = _apply_norm(cfg, p["ln2"], x)
    return x + _apply_mlp(cfg, p["mlp"], h2), conv_s, h_new


# ---------------------------------------------------------------------------
# Full-model forward
# ---------------------------------------------------------------------------

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
        y = _Float32Product.apply(x.reshape(-1, x.shape[-1]), head)
        return constrain(y.reshape(*x.shape[:-1], y.shape[-1]), "logits")
    return constrain(x.float() @ head.float(), "logits")


def _kind_runs(kinds: List[str]) -> List[Tuple[str, int]]:
    """Maximal runs of equal consecutive layer kinds, in order (a hybrid
    pattern becomes several short runs)."""
    runs: List[List] = []
    for k in kinds:
        if runs and runs[-1][0] == k:
            runs[-1][1] += 1
        else:
            runs.append([k, 1])
    return [(k, n) for k, n in runs]


def _layers(cfg: ArchConfig) -> Iterator[Tuple[str, int, int]]:
    """(kind, index in that kind's stack, index in the ``attn`` cache
    stack or -1) of every layer, in model order, walking the runs of
    ``_kind_runs``.  attn and moe layers share the ``attn`` cache stack."""
    cursor: Dict[str, int] = {}
    attnlike = 0
    for kind, count in _kind_runs(cfg.layer_kinds()):
        start = cursor.get(kind, 0)
        cursor[kind] = start + count
        for i in range(start, start + count):
            if kind in ("attn", "moe"):
                yield kind, i, attnlike
                attnlike += 1
            else:
                yield kind, i, -1


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
    if kind in ("attn", "moe"):
        x, _, aux = attn_layer_fwd(cfg, p, x, positions)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, aux
    fwd = mamba2.ssm_block_fwd if kind == "ssm" else rec_layer_fwd
    x, _ = fwd(cfg, p, x)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


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
        for kind, i, _ in _layers(cfg):
            p = per_layer[kind][i]
            if remat:
                x, aux = torch.utils.checkpoint.checkpoint(
                    _train_layer, cfg, kind, p, x, positions,
                    use_reentrant=False)
            else:
                x, aux = _train_layer(cfg, kind, p, x, positions)
            aux_total = aux_total + aux
        x = _apply_norm(cfg, params["final_norm"], x)
        return unembed(cfg, params, x), aux_total

    cap = attn_cache_capacity(cfg, max_len or S)
    # the prompt's states, written layer by layer (pos is set at the end)
    cache: Cache = init_cache(cfg, B, max_len or S, x.dtype, x.device)
    for kind, i, a in _layers(cfg):
        p = layer_params(params["blocks"][kind], i)
        if a >= 0:
            x, (k, v), _ = attn_layer_fwd(cfg, p, x, positions)
            _place_kv(cache["attn"]["k"][a], k, cap)
            _place_kv(cache["attn"]["v"][a], v, cap)
        else:
            fwd = mamba2.ssm_block_fwd if kind == "ssm" else rec_layer_fwd
            x, states = fwd(cfg, p, x)
            # leaves in the order the block returns
            for leaf, st in zip(cache[kind], states):
                cache[kind][leaf][i].copy_(st)
    x = _apply_norm(cfg, params["final_norm"], x)

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
        x = params["embed"][batch["tokens"].reshape(-1)][:, None, :]
    B = x.shape[0]
    pos = cache["pos"]
    if pos.dim() == 0:
        pos = pos.expand(B)
    pos = pos.to(torch.int32).contiguous()
    positions = batch["positions"] if "positions" in batch else pos[:, None]
    k_rows, v_rows = [], []
    for kind, i, a in _layers(cfg):
        p = layer_params(params["blocks"][kind], i)
        if a >= 0:
            x, kn, vn = attn_layer_step(cfg, p, x, positions,
                                        cache["attn"]["k"][a],
                                        cache["attn"]["v"][a], pos)
            k_rows.append(kn)
            v_rows.append(vn)
        elif kind == "ssm":
            conv, state = cache["ssm"]["conv"][i], cache["ssm"]["state"][i]
            y, (conv_new, state_new) = mamba2.ssm_block_step(
                cfg, p, x[:, 0], conv, state)
            conv.copy_(conv_new)
            state.copy_(state_new)
            x = y[:, None]
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
    x = _apply_norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params, x)[:, 0, :]
    if cache["pos"] is pos:
        pos.add_(1)
    else:
        cache["pos"] = pos + 1
    return logits, cache
