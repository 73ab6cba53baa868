"""Model-layout entry points of the kernels (the port of
``repro/kernels/ops.py``).

The model keeps attention tensors as (B, S, H, d); the kernels take
(B, H, S, d).  The adapters here pass transposed *views* (the kernels read
any strides with d innermost), so no layout copy is made.  The SSD scan
and the RG-LRU scan take the model's layout as it is.  Each call goes to
the kernel module's wrapper, which runs the CUDA kernel for CUDA tensors
and the plain version for CPU tensors.

``plain_versions()`` routes every call to the plain versions instead, on
any device — the way ``chip_smoke.py`` runs the same model on the card once
through the kernels and once without them (the reference's
``decode_attn_impl`` switch plays the same role).
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import lora_merge as _lm
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import ssd_scan as _ssd

_PLAIN = [False]


@contextlib.contextmanager
def plain_versions() -> Iterator[None]:
    """Within the block, every op runs its plain PyTorch version."""
    prev = _PLAIN[0]
    _PLAIN[0] = True
    try:
        yield
    finally:
        _PLAIN[0] = prev


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, scale: Optional[float] = None):
    """Model-layout flash attention: q (B,S,Hq,d), k/v (B,S,Hkv,d) ->
    (B,S,Hq,d)."""
    fn = _fa.flash_attention_plain if _PLAIN[0] else _fa.flash_attention
    o = fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
           causal=causal, window=window, q_offset=q_offset, scale=scale)
    return o.transpose(1, 2)


def decode_attention(q, k_cache, v_cache, lens, *, k_new=None, v_new=None,
                     slot_mask=None, scale: Optional[float] = None):
    """Model-layout decode attention: q (B,1,Hq,d), caches (B,C,Hkv,d),
    lens (B,) int32 -> (B,1,Hq,d).  Optional k/v_new (B,1,Hkv,d): the
    current token, folded in after the cache (zero-copy decode).  Optional
    slot_mask (B,C) bool: per-slot validity of a ring-buffered cache."""
    fn = _dec.decode_attention_plain if _PLAIN[0] else _dec.decode_attention
    kn = None if k_new is None else k_new.transpose(1, 2)
    vn = None if v_new is None else v_new.transpose(1, 2)
    o = fn(q[:, 0], k_cache.transpose(1, 2), v_cache.transpose(1, 2), lens,
           k_new=kn, v_new=vn, slot_mask=slot_mask, scale=scale)
    return o[:, None]


def lora_merge(W, A, B, scale: float):
    """Fused W + scale*(A@B) over stacked layers: W (L,Din,Dout)."""
    fn = _lm.lora_merge_plain if _PLAIN[0] else _lm.lora_merge
    return fn(W, A, B, scale)


def ssd_scan(x, dt, A, Bm, Cm, initial_state=None):
    """Mamba-2 SSD: x (B,S,H,P), dt (B,S,H) f32, A (H,) f32, Bm/Cm
    (B,S,N), initial_state (B,H,P,N) f32 or None (zeros) -> (y (B,S,H,P),
    final state (B,H,P,N) f32)."""
    fn = _ssd.ssd_scan_plain if _PLAIN[0] else _ssd.ssd_scan
    return fn(x, dt, A, Bm, Cm, initial_state)


def rglru_scan(log_a, bx, h0=None):
    """RG-LRU recurrence h_t = exp(log_a_t) h_{t-1} + bx_t: log_a/bx
    (B,S,W) f32, h0 (B,W) f32 or None (zeros) -> (y (B,S,W) f32, h_T
    (B,W) f32)."""
    fn = _rg.rglru_scan_plain if _PLAIN[0] else _rg.rglru_scan
    return fn(log_a, bx, h0)


_COUNTED = {"decode_attention": _dec, "flash_attention": _fa,
            "lora_merge": _lm, "ssd_scan": _ssd, "rglru_scan": _rg}


def reset_launch_counts() -> None:
    for mod in _COUNTED.values():
        mod.launches = 0


def launch_counts():
    return {name: mod.launches for name, mod in _COUNTED.items()}


def add_launch_counts(delta) -> None:
    """Add ``delta`` ({kernel: n}) to the counts.  A captured CUDA graph
    counts its kernels' launches once per replay this way: the wrappers'
    counters run only while the graph is captured, when nothing launches
    (the capture takes its own counts back out)."""
    for name, n in delta.items():
        _COUNTED[name].launches += n
