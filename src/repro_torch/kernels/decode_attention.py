"""Decode attention: the CUDA kernel's wrapper, its launch count and its
plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/decode_attention.py``
(``decode_attention`` / ``_decode_kernel``): one query token per (batch
row, query head) against a KV cache, masked by per-row ``lens`` ANDed with
an optional per-slot ``slot_mask`` (ring buffers), with the current
token's ``k_new``/``v_new`` folded into the softmax after the cache
(zero-copy decode: the cache is only read).  Rows with no valid key give
zeros.

On the H100 the work is bound by the bytes of the valid K/V rows, and at
the serving shapes by the latency of one pass over them.  The kernel
(``csrc/decode_attention.cu``) splits the cache across CTAs: a CTA takes
a contiguous range of cache rows for all G <= 16 query heads of its KV
head (each K/V row is read once per group), streams them through shared
memory with cp.async and writes one online-softmax partial (m, l, acc)
per (row, query head, split) to a float32 workspace; the bf16 path runs
its products on the tensor cores (``mma.sync``, the group padded to 16
rows), the float32 path on the CUDA cores.  A second launch merges the
splits in split order (no atomics, so a result does not change between
runs), folds the new token and writes the output.  ``decode_splits``
picks the split count from the shapes alone, never from ``lens``: reading
a device tensor on the host would add a sync to every decode step.

Layouts: q (B, Hq, d); k/v (B, Hkv, C, d) — any strides with d innermost,
so the model's (B, C, Hkv, d) cache is passed as a transposed view without
a copy; lens (B,) int32; k/v_new (B, Hkv, 1, d); slot_mask (B, C) bool ->
out (B, Hq, d).  The wrapper runs the kernel for CUDA tensors (or raises)
and the plain version for CPU tensors.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
SOURCE = "src/repro_torch/kernels/csrc/decode_attention.cu"
REPLACES = "src/repro/kernels/decode_attention.py:162"
HEAD_DIMS = (64, 128, 256)     # the kernel's template head dims

MAX_GROUP = 16        # query heads per KV head the kernel takes
SMS = 132             # streaming multiprocessors of an H100 SXM
TARGET_CTAS = 2 * SMS  # splits cover the SMs about twice
MIN_SPLIT_BYTES = 8192  # bf16 K bytes a split reads at least
MAX_SPLITS = 1024     # the kernel's cap

launches = 0          # wrapper calls that launched the kernels (one each)


def decode_splits(B: int, Hkv: int, C: int, d: int) -> int:
    """The number of cache splits the kernel runs for a (B, Hkv, C, d)
    cache: enough CTAs (splits x Hkv x B) to cover the SMs about twice, no
    split shorter than 8 KB of bf16 K rows (and 16 rows).  Split
    s covers rows [s R, min((s + 1) R, C)) with R = ceil(C / splits); the
    count is chosen so that no split is empty by construction."""
    if C <= 0:
        return 1
    min_rows = max(16, MIN_SPLIT_BYTES // (2 * d))
    want = -(-TARGET_CTAS // max(1, B * Hkv))
    n = max(1, min(want, -(-C // min_rows), MAX_SPLITS))
    rows = -(-C // n)
    return -(-C // rows)


def split_ranges(C: int, splits: int):
    """[begin, end) of the cache rows of each split."""
    rows = -(-C // splits)
    return [(s * rows, min(C, (s + 1) * rows)) for s in range(splits)]


def _cache_partial(qf, k, v, lens, slot_mask, k0, k1, block_k):
    """Online-softmax state (m, l, acc) of cache rows [k0, k1), walked in
    ``block_k`` slices (float32 state)."""
    B, Hkv, G, d = qf.shape
    m = torch.full((B, Hkv, G), NEG_INF, dtype=torch.float32,
                   device=qf.device)
    l = torch.zeros((B, Hkv, G), dtype=torch.float32, device=qf.device)
    acc = torch.zeros((B, Hkv, G, d), dtype=torch.float32, device=qf.device)
    for b0 in range(k0, k1, block_k):
        b1 = min(k1, b0 + block_k)
        kb = k[:, :, b0:b1].float()
        vb = v[:, :, b0:b1].float()
        pos = torch.arange(b0, b1, device=qf.device)
        mask = pos[None, :] < lens[:, None]                  # (B, bk)
        if slot_mask is not None:
            mask = mask & slot_mask[:, b0:b1].bool()
        mask = mask[:, None, None, :]
        s = torch.einsum("bhgd,bhcd->bhgc", qf, kb)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgc,bhcd->bhgd", p, vb)
        m = m_new
    return m, l, acc


def decode_attention_plain(q, k, v, lens, *, k_new=None, v_new=None,
                           slot_mask=None, scale: Optional[float] = None,
                           block_k: int = 512, splits: Optional[int] = None):
    """The plain version: blocked online softmax over the cache in
    ``block_k`` slices (float32 state), then the new-token fold.

    ``splits``: the kernel's blocking instead.  Each of the ``splits``
    ranges of ``split_ranges`` gets its own state (walked in ``block_k``
    slices), and the states merge as the kernel's second launch merges
    them: in split order, a split with no valid key (l = 0) skipped."""
    B, Hq, d = q.shape
    _, Hkv, C, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else d ** -0.5
    qf = q.float().reshape(B, Hkv, G, d) * scale
    lens = lens.to(q.device)
    if splits is None:
        m, l, acc = _cache_partial(qf, k, v, lens, slot_mask, 0, C, block_k)
    else:
        parts = [_cache_partial(qf, k, v, lens, slot_mask, k0, k1, block_k)
                 for k0, k1 in split_ranges(C, splits)]
        m = torch.full((B, Hkv, G), NEG_INF, dtype=torch.float32,
                       device=q.device)
        for m_s, l_s, _ in parts:
            m = torch.where(l_s > 0, torch.maximum(m, m_s), m)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Hkv, G, d), dtype=torch.float32,
                          device=q.device)
        for m_s, l_s, acc_s in parts:                        # split order
            w = torch.where(l_s > 0, torch.exp(m_s - m), 0.0)
            l = l + l_s * w
            acc = acc + acc_s * w[..., None]
    if k_new is not None:
        kn = k_new[:, :, 0].float()                          # (B, Hkv, d)
        vn = v_new[:, :, 0].float()
        s_new = torch.einsum("bhgd,bhd->bhg", qf, kn)
        m2 = torch.maximum(m, s_new)
        c = torch.exp(m - m2)
        p_new = torch.exp(s_new - m2)
        l = l * c + p_new
        acc = acc * c[..., None] + p_new[..., None] * vn[:, :, None, :]
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l[..., None]).reshape(B, Hq, d).to(q.dtype)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"decode_attention kernel: {msg}")


def _check_rows(t, name: str, dtype, device) -> None:
    _require(t.is_cuda and t.device == device, f"{name} must be on {device}")
    _require(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
    _require(t.stride(-1) == 1, f"{name} needs a contiguous last dim")
    _require(t.data_ptr() % 16 == 0
             and all(t.stride(i) % 8 == 0 for i in range(t.dim() - 1)),
             f"{name} rows must be 16-byte aligned")


def decode_attention(q, k, v, lens, *, k_new=None, v_new=None,
                     slot_mask=None, scale: Optional[float] = None):
    """q: (B, Hq, d); k/v: (B, Hkv, C, d); lens: (B,) int32 -> (B, Hq, d).

    CPU tensors run ``decode_attention_plain``; CUDA tensors launch the
    kernel or raise."""
    if not q.is_cuda:
        return decode_attention_plain(q, k, v, lens, k_new=k_new,
                                      v_new=v_new, slot_mask=slot_mask,
                                      scale=scale)
    global launches
    B, Hq, d = q.shape
    _require(k.dim() == 4 and k.shape == v.shape and k.shape[0] == B
             and k.shape[3] == d, f"cache shapes {tuple(k.shape)} / "
             f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    Hkv, C = k.shape[1], k.shape[2]
    _require(Hq % Hkv == 0, f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    _require(Hq // Hkv <= MAX_GROUP,
             f"group of {Hq // Hkv} query heads > {MAX_GROUP}")
    _require(d in HEAD_DIMS, f"head dim {d} not in {HEAD_DIMS}")
    dev, dt = q.device, q.dtype
    build.dtype_code(dt)
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_rows(t, name, dt, dev)
    _require(lens.device == dev and lens.dtype == torch.int32
             and lens.shape == (B,) and lens.is_contiguous(),
             "lens must be a contiguous (B,) int32 tensor on q's device")
    _require((k_new is None) == (v_new is None),
             "k_new and v_new come together")
    if k_new is not None:
        for t, name in ((k_new, "k_new"), (v_new, "v_new")):
            _require(t.shape == (B, Hkv, 1, d), f"{name} must be (B, Hkv, 1, d)")
            _check_rows(t, name, dt, dev)
    if slot_mask is not None:
        _require(slot_mask.device == dev and slot_mask.dtype == torch.bool
                 and slot_mask.shape == (B, C) and slot_mask.stride(1) == 1,
                 "slot_mask must be a (B, C) bool tensor, C contiguous")
    out = torch.empty((B, Hq, d), dtype=dt, device=dev)
    splits = decode_splits(B, Hkv, C, d)
    ws = torch.empty((B * Hq * splits * (d + 2),), dtype=torch.float32,
                     device=dev)          # partials: acc, then (m, l)
    st = build.strides((q, (0, 1)), (k, (0, 1, 2)), (v, (0, 1, 2)),
                       (k_new, (0, 1)) if k_new is not None else (None, 2),
                       (v_new, (0, 1)) if v_new is not None else (None, 2),
                       (slot_mask, (0,)) if slot_mask is not None
                       else (None, 1),
                       (out, (0, 1)))
    err = build.load().pb_decode_attention(
        build.dtype_code(dt), dev.index, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), lens.data_ptr(), build.ptr(k_new), build.ptr(v_new),
        build.ptr(slot_mask), out.data_ptr(), ws.data_ptr(), st, B, Hq,
        Hkv, C, d, splits, float(scale if scale is not None else d ** -0.5),
        build.stream_of(q))
    build.check(err, "decode_attention")
    launches += 1
    return out
