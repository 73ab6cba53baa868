"""Operations and bytes the work needs, frozen with the benchmark.

``decode_attention_cost`` and ``flash_attention_cost`` are copies of the
``cost()`` functions of the program's ``kernels/decode_attention.py`` and
``kernels/flash_attention.py`` (with ``visible_pairs``): a later change to
the program cannot move the count its kernels are held to.
``decode_step_cost`` counts what one whole decode step of the model needs,
and ``attn_layers`` how many of its layers attend: the default attention
stack's, or what the configuration's reference module states
(``manifest``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from pbb import manifest


def itemsize(dtype: str) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4}[dtype]


def decode_attention_cost(*, batch: int, heads: int, kv_heads: int,
                          head_dim: int, cache_len: int,
                          valid_rows: Optional[int] = None, fold: bool = True,
                          slot_mask: bool = False,
                          dtype: str = "bfloat16") -> Tuple[int, int, str]:
    """(operations, bytes, peak dtype) of one decode-attention call on a
    (batch, kv_heads, cache_len, head_dim) cache: q, the new token's K/V
    (``fold``), lens and the slot mask read once, only the ``valid_rows``
    cache rows the lengths let in, the output written once; two products
    of ``head_dim`` per (query head, visible key)."""
    it = itemsize(dtype)
    valid = batch * cache_len if valid_rows is None else valid_rows
    q = batch * heads * head_dim * it
    new = 2 * batch * kv_heads * head_dim * it if fold else 0
    nbytes = (2 * q + new + 4 * batch + (batch * cache_len if slot_mask
                                         else 0)
              + 2 * valid * kv_heads * head_dim * it)
    flops = 4 * heads * head_dim * (valid + (batch if fold else 0))
    return flops, nbytes, dtype


def visible_pairs(q_len: int, kv_len: int, *, causal: bool, window: int,
                  q_offset: int) -> int:
    """(query, key) pairs the mask lets through, per (row, head)."""
    total = 0
    for i in range(q_len):
        p = q_offset + i
        lo = max(0, p - window + 1) if window > 0 else 0
        hi = min(kv_len, p + 1) if causal else kv_len
        total += max(0, hi - lo)
    return total


def flash_attention_cost(*, batch: int, q_len: int, kv_len: int, heads: int,
                         kv_heads: int, head_dim: int, causal: bool = True,
                         window: int = 0, q_offset: int = 0,
                         dtype: str = "bfloat16") -> Tuple[int, int, str]:
    """(operations, bytes, peak dtype) of one forward flash call: q, k and
    v read once and the output written once; two products of ``head_dim``
    per visible (query, key) pair and head."""
    it = itemsize(dtype)
    q = batch * q_len * heads * head_dim * it
    kv = 2 * batch * kv_len * kv_heads * head_dim * it
    pairs = visible_pairs(q_len, kv_len, causal=causal, window=window,
                          q_offset=q_offset)
    return 4 * batch * heads * head_dim * pairs, 2 * q + kv, dtype


def attn_layers(m: Dict) -> int:
    """The layers that attend and hold K/V rows: the reference module's
    ``attn_layers(m)`` where it has one, else every layer."""
    hook = manifest.layout_hook(m, "attn_layers")
    return hook(m) if hook else m["n_layers"]


def decode_step_cost(m: Dict, n_live: int, cached_rows: int,
                     routed_read: Optional[int] = None) -> Tuple[float, float]:
    """(operations, bytes) one decode step needs at least, for ``n_live``
    live rows whose caches hold ``cached_rows`` positions in all: the
    reference module's ``decode_step_cost`` where it has one.  For the
    default attention stack: every weight read once (an MoE layer's routed
    experts only ``routed_read`` of them, by default ``top_k``: the fewest
    any routing reads), the live K/V rows read once, each new K/V row
    written once, the logits over the vocabulary written once; two
    operations per weight and live row, and the attention's two products
    per visible key."""
    hook = manifest.layout_hook(m, "decode_step_cost")
    if hook:
        return hook(m, n_live, cached_rows, routed_read)
    it = itemsize(m["dtype"])
    D, L = m["d_model"], m["n_layers"]
    hd = m["head_dim"] or D // m["n_heads"]
    Hq, Hkv, V = m["n_heads"], m["n_kv_heads"], m["vocab_size"]
    attn_w = D * Hq * hd + 2 * D * Hkv * hd + Hq * hd * D
    if m.get("n_experts", 0):
        E, K, Fm = m["n_experts"], m["top_k"], m["moe_d_ff"]
        S = m.get("n_shared_experts", 0)
        read = K if routed_read is None else routed_read
        ffn_read = D * E + (read + S) * 3 * D * Fm + (D if S else 0)
        ffn_work = D * E + (K + S) * 3 * D * Fm + (D if S else 0)
    else:
        ffn_read = ffn_work = (3 if m["gated_mlp"] else 2) * D * m["d_ff"]
    norms = 2 * D * L + D
    head = V * D
    weights_read = L * (attn_w + ffn_read) + norms + head + n_live * D
    kv_row = 2 * Hkv * hd * it                      # K and V of one layer
    nbytes = (weights_read * it + L * kv_row * (cached_rows + n_live)
              + 4 * n_live * V)
    flops = (2 * n_live * (L * (attn_w + ffn_work) + head)
             + L * 4 * Hq * hd * (cached_rows + n_live))
    return float(flops), float(nbytes)
