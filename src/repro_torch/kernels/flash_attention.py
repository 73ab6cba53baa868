"""Flash attention (prefill): the CUDA kernel's wrapper, its launch count
and its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention`` / ``_flash_kernel``): online-softmax attention with a
causal mask, a sliding ``window`` and ``q_offset`` for continued prefill,
GQA by query head h reading KV head h // G.  It is the prefill attention of
the serving path, i.e. the compute behind the time to first token.

On the H100 the kernel (``csrc/flash_attention.cu``) runs the bf16 path's
products on the tensor cores: one warpgroup owns a 64-row query tile, S =
Q K^T and O += P V are ``wgmma`` instructions (P from registers, rounded
to bf16), and K/V tiles of 64 keys (32 at head dim 256) stream through a
ring of 3-4 stages in shared memory filled by ``cp.async`` while earlier
tiles are multiplied; query tiles run longest first.  The float32 path keeps the
products on the CUDA cores in full float32 (two or four threads a query
row).  Both mask ragged edges in the kernel (no padding copies) and never
load a key tile that the causal mask or the window hides from its whole
query tile.

Layouts: q (B, Hq, Sq, d); k/v (B, Hkv, Sk, d) — any strides with d
innermost, so model-layout (B, S, H, d) tensors pass as transposed views ->
out (B, Hq, Sq, d), a view of memory laid out (B, Sq, Hq, d).  The wrapper
runs the kernel for CUDA tensors (or raises) and the plain version for CPU
tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:102"
HEAD_DIMS = (64, 128, 256)     # the kernel's template head dims

launches = 0          # kernel launches since the last reset


def visible_keys(Sk: int, q_lo: int, q_hi: int, *, causal: bool,
                 window: int) -> Tuple[int, int]:
    """[begin, end) of the keys that queries at positions q_lo..q_hi-1 can
    see; key blocks outside it are fully masked and skipped."""
    end = min(Sk, q_hi) if causal else Sk
    begin = max(0, q_lo - window + 1) if window > 0 else 0
    return begin, end


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          q_offset: int = 0, scale: Optional[float] = None,
                          block_q: int = 128, block_k: int = 128):
    """The plain version: the same blocked online softmax in float32, one
    (block_q, block_k) tile at a time, fully masked key blocks skipped."""
    B, Hq, Sq, d = q.shape
    _, Hkv, Sk, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else d ** -0.5
    qf = q.float().reshape(B, Hkv, G, Sq, d) * scale
    out = torch.zeros((B, Hkv, G, Sq, d), dtype=torch.float32,
                      device=q.device)
    for q0 in range(0, Sq, block_q):
        qb = qf[:, :, :, q0:q0 + block_q]
        nq = qb.shape[3]
        q_pos = q_offset + torch.arange(q0, q0 + nq, device=q.device)
        m = torch.full((B, Hkv, G, nq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Hkv, G, nq, d), dtype=torch.float32,
                          device=q.device)
        begin, end = visible_keys(Sk, q_offset + q0, q_offset + q0 + nq,
                                  causal=causal, window=window)
        for k0 in range((begin // block_k) * block_k, end, block_k):
            kb = k[:, :, k0:k0 + block_k].float()
            vb = v[:, :, k0:k0 + block_k].float()
            k_pos = torch.arange(k0, k0 + kb.shape[2], device=q.device)
            mask = torch.ones((nq, kb.shape[2]), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= k_pos[None, :] <= q_pos[:, None]
            if window > 0:
                mask &= k_pos[None, :] > q_pos[:, None] - window
            s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kb)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bhkd->bhgqd",
                                                       p, vb)
            m = m_new
        l = torch.where(l == 0.0, 1.0, l)
        out[:, :, :, q0:q0 + nq] = acc / l[..., None]
    return out.reshape(B, Hq, Sq, d).to(q.dtype)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention kernel: {msg}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, scale: Optional[float] = None):
    """q: (B, Hq, Sq, d); k/v: (B, Hkv, Sk, d) -> (B, Hq, Sq, d).

    CPU tensors run ``flash_attention_plain``; CUDA tensors launch the
    kernel or raise."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, scale=scale)
    global launches
    B, Hq, Sq, d = q.shape
    _require(k.dim() == 4 and k.shape == v.shape and k.shape[0] == B
             and k.shape[3] == d, f"k/v shapes {tuple(k.shape)} / "
             f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    Hkv, Sk = k.shape[1], k.shape[2]
    _require(Hq % Hkv == 0, f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    _require(d in HEAD_DIMS, f"head dim {d} not in {HEAD_DIMS}")
    _require(window >= 0 and q_offset >= 0, "window and q_offset are >= 0")
    dev, dt = q.device, q.dtype
    build.dtype_code(dt)
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _require(t.is_cuda and t.device == dev, f"{name} must be on {dev}")
        _require(t.dtype == dt, f"{name} must be {dt}, got {t.dtype}")
        _require(t.stride(-1) == 1, f"{name} needs a contiguous last dim")
        _require(t.data_ptr() % 16 == 0
                 and all(t.stride(i) % 8 == 0 for i in range(3)),
                 f"{name} rows must be 16-byte aligned")
    out = torch.empty((B, Sq, Hq, d), dtype=dt, device=dev).transpose(1, 2)
    st = build.strides((q, (0, 1, 2)), (k, (0, 1, 2)), (v, (0, 1, 2)),
                       (out, (0, 1, 2)))
    err = build.load().pb_flash_attention(
        build.dtype_code(dt), dev.index, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), st, B, Hq, Hkv, Sq, Sk, d,
        int(causal), int(window), int(q_offset),
        float(scale if scale is not None else d ** -0.5),
        build.stream_of(q))
    build.check(err, "flash_attention")
    launches += 1
    return out
