"""Attention for the port (the port of ``repro/models/attention.py``).

``attention_partial`` is the plain blocked online-softmax attention that
returns mergeable (acc, m, l) partials; ``merge_partials`` and
``finalize_partial`` combine and normalise them.  The model's hot calls go
through the kernels: ``attention`` (prefill) runs the flash-attention
kernel and ``decode_attention`` / ``decode_attention_merged`` (decode) run
the decode kernel — on CPU tensors each kernel wrapper runs its plain
version (``repro_torch.kernels``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops

NEG_INF = -1e30


class AttnPartial(NamedTuple):
    acc: torch.Tensor  # (B, Sq, Hq, hd) un-normalized weighted values (f32)
    m: torch.Tensor    # (B, Sq, Hq) running max of logits (f32)
    l: torch.Tensor    # (B, Sq, Hq) running sum of exp(logit - m) (f32)


def merge_partials(a: AttnPartial, b: AttnPartial) -> AttnPartial:
    """Associative merge of two online-softmax partial results."""
    m = torch.maximum(a.m, b.m)
    ea = torch.exp(a.m - m)
    eb = torch.exp(b.m - m)
    acc = a.acc * ea[..., None] + b.acc * eb[..., None]
    l = a.l * ea + b.l * eb
    return AttnPartial(acc, m, l)


def finalize_partial(p: AttnPartial, dtype) -> torch.Tensor:
    l = torch.where(p.l == 0.0, 1.0, p.l)
    return (p.acc / l[..., None]).to(dtype)


def _block_mask(q_pos, k_pos, *, causal: bool, window: int):
    """(Bq, Bk) bool mask: True = attend."""
    dq = q_pos[:, None]
    dk = k_pos[None, :]
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok = ok & (dk <= dq)
    if window > 0:
        ok = ok & (dk > dq - window)
    return ok


def attention_partial(q, k, v, *, causal: bool = True, window: int = 0,
                      q_offset: int = 0, k_offset: int = 0,
                      kv_valid_len=None, kv_slot_mask=None,
                      block_k: int = 1024,
                      scale: Optional[float] = None) -> AttnPartial:
    """Blocked online-softmax attention returning mergeable partials.

    q: (B, Sq, Hq, hd); k/v: (B, Sk, Hkv, hd).  GQA: query heads are
    grouped onto KV heads.  ``kv_valid_len`` (scalar or (B,)) masks keys at
    or past it; ``kv_slot_mask`` (B, Sk) masks per slot."""
    B, Sq, Hq, hd = q.shape
    _, Sk, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    G = Hq // Hkv
    scale = scale if scale is not None else hd ** -0.5
    dev = q.device
    qf = (q.float() * scale).reshape(B, Sq, Hkv, G, hd)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    nk = max(1, (Sk + block_k - 1) // block_k)
    block_k = (Sk + nk - 1) // nk
    vl = None
    if kv_valid_len is not None:
        vl = torch.as_tensor(kv_valid_len, device=dev)
    acc = torch.zeros((B, Sq, Hkv, G, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, Sq, Hkv, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, Hkv, G), dtype=torch.float32, device=dev)
    for kidx in range(nk):
        lo = kidx * block_k
        kblk = k[:, lo:lo + block_k].float()
        vblk = v[:, lo:lo + block_k].float()
        k_pos = k_offset + torch.arange(lo, lo + kblk.shape[1], device=dev)
        s = torch.einsum("bqkgd,bckd->bqkgc", qf, kblk)
        mask = _block_mask(q_pos, k_pos, causal=causal, window=window)
        mask = mask[None, :, None, None, :]
        if vl is not None:
            if vl.dim() == 0:
                mask = mask & (k_pos < vl)[None, None, None, None, :]
            else:
                mask = mask & (k_pos[None, :] < vl[:, None]
                               )[:, None, None, None, :]
        if kv_slot_mask is not None:
            sblk = kv_slot_mask[:, lo:lo + block_k].bool()
            mask = mask & sblk[:, None, None, None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p,
                                                   vblk)
        m = m_new
    return AttnPartial(acc.reshape(B, Sq, Hq, hd), m.reshape(B, Sq, Hq),
                       l.reshape(B, Sq, Hq))


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              q_offset: int = 0, scale: Optional[float] = None
              ) -> torch.Tensor:
    """Full attention, shapes as ``attention_partial``: the model's prefill,
    through the flash-attention kernel (keys start at position 0, queries
    at ``q_offset``)."""
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, scale=scale)


def _lens(cache_len, B: int, device) -> torch.Tensor:
    lens = torch.as_tensor(cache_len, dtype=torch.int32, device=device)
    return lens.reshape(-1).expand(B).contiguous()


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One-token attention against a KV cache (decode kernel).

    q: (B, 1, Hq, hd); k/v_cache: (B, C, Hkv, hd); cache_len: () or (B,)
    valid entries."""
    return ops.decode_attention(q, k_cache, v_cache,
                                _lens(cache_len, q.shape[0], q.device),
                                scale=scale)


def decode_attention_merged(q, k_cache, v_cache, cache_len, k_new, v_new, *,
                            kv_slot_mask=None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Zero-copy decode attention: the current token's K/V (B, 1, Hkv, hd)
    fold into the softmax after the cache, which is only read — equal to
    writing them at position ``cache_len`` and attending ``cache_len + 1``
    entries.  ``kv_slot_mask`` (B, C) bool masks the evicted slot of a
    ring-buffered (windowed) cache."""
    return ops.decode_attention(q, k_cache, v_cache,
                                _lens(cache_len, q.shape[0], q.device),
                                k_new=k_new, v_new=v_new,
                                slot_mask=kv_slot_mask, scale=scale)
