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

``traced(tracer)`` hands every call to ``tracer(name, args, kwargs)``
instead, in the model's layout, and returns what it returns: the dry run
(``launch/dryrun.py``) charges each call by its kernel module's ``cost()``
at the call's shard shapes and makes the output's shape without running
the kernel or its plain version.  Nothing launches, so nothing is counted.

DTensors (a train step sharded over a process group, ``launch/train.py``)
take one route, ``_on_rows``: ``local_map`` over the same call, with
each input's batch rows kept split over the mesh dims that split them
and every other dim made whole on each rank (a sequence split over
'model' is all-gathered, under autograd).  Each rank then runs the kernel
(or, for CPU tensors, its plain version) on its own rows with the whole
sequence, which is the reference's semantics, and the outputs come back
in the input's own placements.  ``decode_attention`` and ``lora_merge``
serve only and refuse a DTensor.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import lora_merge as _lm
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import ssd_scan as _ssd

_PLAIN = [False]
_TRACER = [None]


@contextlib.contextmanager
def plain_versions() -> Iterator[None]:
    """Within the block, every op runs its plain PyTorch version."""
    prev = _PLAIN[0]
    _PLAIN[0] = True
    try:
        yield
    finally:
        _PLAIN[0] = prev


@contextlib.contextmanager
def traced(tracer: Callable) -> Iterator[None]:
    """Within the block, every op is handed to ``tracer``."""
    prev = _TRACER[0]
    _TRACER[0] = tracer
    try:
        yield
    finally:
        _TRACER[0] = prev


def _any_dtensor(*ts) -> bool:
    return any(type(t).__name__ == "DTensor" for t in ts)


def _refuse_dtensors(name: str, *ts) -> None:
    if _any_dtensor(*ts):
        raise TypeError(f"{name} serves one device and takes no DTensor; "
                        f"call it on each rank's local tensors")


def _on_rows(fn, args, batched, given_back):
    """``fn(*args)`` on each rank's batch rows (see the module
    docstring).  ``batched[i]``: whether args[i]'s dim 0 is the batch
    (else it is made whole on every rank); ``given_back[j]``: whether
    output j is laid out like ``args[0]`` (else it keeps the rows'
    split: a final state).  The first argument must be a DTensor."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.shardings import row_placements
    lead = args[0]
    mesh = lead.device_mesh
    rows, whole, summed = row_placements(lead.placements)
    run = local_map(
        fn, out_placements=tuple(rows for _ in given_back),
        in_placements=tuple((rows if b else whole) for b in batched),
        in_grad_placements=tuple((rows if b else summed) for b in batched),
        device_mesh=mesh, redistribute_inputs=True)
    outs = run(*args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    back = tuple(o.redistribute(mesh, lead.placements) if g else o
                 for o, g in zip(outs, given_back))
    return back if len(back) > 1 else back[0]


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, scale: Optional[float] = None):
    """Model-layout flash attention: q (B,S,Hq,d), k/v (B,S,Hkv,d) ->
    (B,S,Hq,d)."""
    if _TRACER[0] is not None:
        return _TRACER[0]("flash_attention", (q, k, v),
                          dict(causal=causal, window=window,
                               q_offset=q_offset))
    fn = _fa.flash_attention_plain if _PLAIN[0] else _fa.flash_attention

    def run(q, k, v):
        o = fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
               causal=causal, window=window, q_offset=q_offset, scale=scale)
        return o.transpose(1, 2)
    if _any_dtensor(q, k, v):
        return _on_rows(run, (q, k, v), (True, True, True), (True,))
    return run(q, k, v)


def decode_attention(q, k_cache, v_cache, lens, *, k_new=None, v_new=None,
                     slot_mask=None, scale: Optional[float] = None):
    """Model-layout decode attention: q (B,1,Hq,d), caches (B,C,Hkv,d),
    lens (B,) int32 -> (B,1,Hq,d).  Optional k/v_new (B,1,Hkv,d): the
    current token, folded in after the cache (zero-copy decode).  Optional
    slot_mask (B,C) bool: per-slot validity of a ring-buffered cache."""
    if _TRACER[0] is not None:
        return _TRACER[0]("decode_attention", (q, k_cache, v_cache, lens),
                          dict(k_new=k_new, v_new=v_new,
                               slot_mask=slot_mask))
    _refuse_dtensors("decode_attention", q, k_cache, v_cache, lens, k_new,
                     v_new, slot_mask)
    fn = _dec.decode_attention_plain if _PLAIN[0] else _dec.decode_attention
    kn = None if k_new is None else k_new.transpose(1, 2)
    vn = None if v_new is None else v_new.transpose(1, 2)
    o = fn(q[:, 0], k_cache.transpose(1, 2), v_cache.transpose(1, 2), lens,
           k_new=kn, v_new=vn, slot_mask=slot_mask, scale=scale)
    return o[:, None]


def lora_merge(W, A, B, scale: float):
    """Fused W + scale*(A@B) over stacked layers: W (L,Din,Dout)."""
    if _TRACER[0] is not None:
        return _TRACER[0]("lora_merge", (W, A, B), {})
    _refuse_dtensors("lora_merge", W, A, B)
    fn = _lm.lora_merge_plain if _PLAIN[0] else _lm.lora_merge
    return fn(W, A, B, scale)


def ssd_scan(x, dt, A, Bm, Cm, initial_state=None):
    """Mamba-2 SSD: x (B,S,H,P), dt (B,S,H) f32, A (H,) f32, Bm/Cm
    (B,S,N), initial_state (B,H,P,N) f32 or None (zeros) -> (y (B,S,H,P),
    final state (B,H,P,N) f32)."""
    if _TRACER[0] is not None:
        return _TRACER[0]("ssd_scan", (x, dt, A, Bm, Cm),
                          dict(initial_state=initial_state))
    fn = _ssd.ssd_scan_plain if _PLAIN[0] else _ssd.ssd_scan
    if _any_dtensor(x, dt, A, Bm, Cm, initial_state):
        if initial_state is None:
            return _on_rows(lambda *a: fn(*a, None), (x, dt, A, Bm, Cm),
                            (True, True, False, True, True), (True, False))
        return _on_rows(fn, (x, dt, A, Bm, Cm, initial_state),
                        (True, True, False, True, True, True),
                        (True, False))
    return fn(x, dt, A, Bm, Cm, initial_state)


def rglru_scan(log_a, bx, h0=None):
    """RG-LRU recurrence h_t = exp(log_a_t) h_{t-1} + bx_t: log_a/bx
    (B,S,W) f32, h0 (B,W) f32 or None (zeros) -> (y (B,S,W) f32, h_T
    (B,W) f32)."""
    if _TRACER[0] is not None:
        return _TRACER[0]("rglru_scan", (log_a, bx), dict(h0=h0))
    fn = _rg.rglru_scan_plain if _PLAIN[0] else _rg.rglru_scan
    if _any_dtensor(log_a, bx, h0):
        if h0 is None:
            return _on_rows(lambda a, b: fn(a, b, None), (log_a, bx),
                            (True, True), (True, False))
        return _on_rows(fn, (log_a, bx, h0), (True, True, True),
                        (True, False))
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
