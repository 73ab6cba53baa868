"""Naive oracles for the ported kernels (the port of
``repro/kernels/ref.py``): the whole score matrix in memory, no tiling and
no online softmax, and the SSD and RG-LRU scans as their token-by-token
recurrences, so a blocking bug in a kernel or its plain version cannot
hide behind shared structure.  Tests only; nothing on the serving path
calls these.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=0, q_offset=0,
                        scale=None):
    """q: (B, Hq, Sq, d); k/v: (B, Hkv, Sk, d) -> (B, Hq, Sq, d)."""
    B, Hq, Sq, d = q.shape
    _, Hkv, Sk, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else d ** -0.5
    kk = k.repeat_interleave(G, dim=1).float()
    vv = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask[None, None], p, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


def decode_attention_ref(q, k, v, lens, *, slot_mask=None, scale=None):
    """q: (B, Hq, d); k/v: (B, Hkv, C, d); lens: (B,) -> (B, Hq, d).
    ``slot_mask`` (B, C) is ANDed with the prefix-length mask."""
    B, Hq, d = q.shape
    _, Hkv, C, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else d ** -0.5
    kk = k.repeat_interleave(G, dim=1).float()
    vv = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhd,bhcd->bhc", q.float(), kk) * scale
    mask = torch.arange(C, device=q.device)[None, :] < lens[:, None]
    if slot_mask is not None:
        mask = mask & slot_mask.bool()
    s = torch.where(mask[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask[:, None, :], p, 0.0)
    return torch.einsum("bhc,bhcd->bhd", p, vv).to(q.dtype)


def lora_merge_ref(W, A, B, scale):
    delta = torch.einsum("ldr,lro->ldo", A.float(), B.float())
    return (W.float() + scale * delta).to(W.dtype)


def ssd_scan_ref(x, dt, A, Bm, Cm):
    """Sequential recurrent oracle.  x: (B,S,H,P); dt: (B,S,H); A: (H,);
    Bm/Cm: (B,S,N) -> (y (B,S,H,P), state (B,H,P,N) float32)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    a = A.float()
    state = torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
    ys = []
    for t in range(S):
        xt = x[:, t].float()                       # (B,H,P)
        dtt = dt[:, t].float()                     # (B,H)
        bt = Bm[:, t].float()                      # (B,N)
        ct = Cm[:, t].float()
        dA = torch.exp(dtt * a)
        dBx = torch.einsum("bh,bn,bhp->bhpn", dtt, bt, xt)
        state = state * dA[..., None, None] + dBx
        ys.append(torch.einsum("bn,bhpn->bhp", ct, state))
    y = torch.stack(ys, dim=1) if ys else x.float()[:, :0]
    return y.to(x.dtype), state


def rglru_scan_ref(log_a, bx, h0=None):
    """Sequential oracle.  log_a/bx: (B,S,W) -> (h_seq (B,S,W) in log_a's
    dtype, h_T (B,W) float32)."""
    B, S, W = log_a.shape
    h = (torch.zeros((B, W), dtype=torch.float32, device=log_a.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        h = torch.exp(log_a[:, t].float()) * h + bx[:, t].float()
        ys.append(h)
    y = torch.stack(ys, dim=1) if ys else log_a.float()[:, :0]
    return y.to(log_a.dtype), h
