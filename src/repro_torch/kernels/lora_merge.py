"""Fused merged-LoRA weight update: the CUDA kernel's wrapper, its launch
count and its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/lora_merge.py``
(``lora_merge`` / ``_lora_kernel``), the adapter switch of paper §4.3.2:
W' = W + scale * (A @ B) over stacked layers, float32 accumulation, cast
to W's dtype.

On the H100 the merge is bound by the bytes of W read and W' written.  The
kernel (``csrc/lora_merge.cu``) makes one streaming pass over W with a
persistent grid: each CTA walks a run of 64 x 128 tiles down a column
strip, requests a tile's W before it computes the tile's rank-r delta
(float32, register-tiled 8 x 8 a thread), stages B's column block once per
strip and double-buffers A's row blocks, so the delta never exists in
device memory.

Layouts: W (L, Din, Dout) bfloat16 or float32; A (L, Din, r) and
B (L, r, Dout) float32 (``init_lora``'s default) -> W' like W.  The wrapper
runs the kernel for CUDA tensors (or raises) and the plain version for CPU
tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/csrc/lora_merge.cu"
REPLACES = "src/repro/kernels/lora_merge.py:48"
MAX_RANK = 32

launches = 0          # kernel launches since the last reset


def cost(*, layers: int, d_in: int, d_out: int, rank: int,
         dtype: str = "bfloat16"):
    """(operations, bytes, peak dtype) of one merge: W read and W'
    written once in ``dtype``, the float32 factors A and B read once; per
    element of W a rank-``rank`` dot product and the add.  The products
    run in float32 on the CUDA cores, so the float32 peak applies."""
    it = 2 if dtype in ("bfloat16", "float16") else 4
    nbytes = (2 * layers * d_in * d_out * it
              + 4 * layers * rank * (d_in + d_out))
    return layers * d_in * d_out * (2 * rank + 1), nbytes, "float32"


def lora_merge_plain(W, A, B, scale: float):
    """The plain version: the float32 product, added and cast back."""
    delta = torch.bmm(A.float(), B.float())
    return (W.float() + scale * delta).to(W.dtype)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"lora_merge kernel: {msg}")


def lora_merge(W, A, B, scale: float):
    """W: (L, Din, Dout); A: (L, Din, r); B: (L, r, Dout) -> W + scale*A@B.

    CPU tensors run ``lora_merge_plain``; CUDA tensors launch the kernel
    or raise."""
    if not W.is_cuda:
        return lora_merge_plain(W, A, B, scale)
    global launches
    _require(W.dim() == 3 and A.dim() == 3 and B.dim() == 3, "3-d operands")
    L, Din, Dout = W.shape
    r = A.shape[-1]
    _require(A.shape == (L, Din, r) and B.shape == (L, r, Dout),
             f"A {tuple(A.shape)} / B {tuple(B.shape)} do not match "
             f"W {tuple(W.shape)}")
    _require(1 <= r <= MAX_RANK, f"rank {r} not in [1, {MAX_RANK}]")
    _require(Dout % 8 == 0, f"Dout={Dout} is not a multiple of 8")
    dev = W.device
    build.dtype_code(W.dtype)
    for t, name in ((W, "W"), (A, "A"), (B, "B")):
        _require(t.is_cuda and t.device == dev, f"{name} must be on {dev}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(W.data_ptr() % 16 == 0 and B.data_ptr() % 16 == 0,
             "W and B must be 16-byte aligned")
    _require(A.dtype == torch.float32 and B.dtype == torch.float32,
             f"A and B must be float32, got {A.dtype} / {B.dtype}")
    out = torch.empty_like(W)
    err = build.load().pb_lora_merge(
        build.dtype_code(W.dtype), dev.index, W.data_ptr(), A.data_ptr(),
        B.data_ptr(), out.data_ptr(), L, Din, Dout, r, float(scale),
        build.stream_of(W))
    build.check(err, "lora_merge")
    launches += 1
    return out
