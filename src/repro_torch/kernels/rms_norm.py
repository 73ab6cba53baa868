"""Fused residual add and RMSNorm: the CUDA kernel's wrapper, its launch
count and its plain PyTorch version.

Replaces no TPU kernel: the JAX package leaves its norms to XLA, which
fuses each into one loop.  It was added because the captured decode step
ran every RMSNorm as nine small PyTorch kernels (casts, square, mean, the
eps add, rsqrt, two products, the cast back) and a residual add before it
as a tenth; inside the step's CUDA graph each costs its launch latency,
while the bytes at opt-1.3b's decode rows (32 x 2048 bf16) take a fraction
of a microsecond.

On the H100 the work is bound by its bytes (x, the residual and w read
once, s and h written once), and at decode sizes by one launch.  The
kernel (``csrc/rms_norm.cu``) runs a CTA a row with 16-byte loads, keeps
the row in registers, sums the squares in float32 by warp shuffles and
shared memory and writes s and h once.  Its arithmetic and order are the
plain version's (``models/layers.py``'s ``rms_norm`` after a rounded
add), every step rounded to nearest, so only the sum's order differs: the
output is within one ulp of the output dtype.

Layouts: x (..., D) contiguous; w (D,); residual like x; one dtype for
all (bfloat16 or float32), 16-byte aligned, D a multiple of 8 (bf16) or 4
(float32) and at most 16,384 (bf16) or 8,192 (float32).  Returns h, or
(s, h) with a residual.  The wrapper runs the kernel for CUDA tensors (or
raises) and the plain version for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.models.layers import rms_norm as _norm

SOURCE = "src/repro_torch/kernels/csrc/rms_norm.cu"
REPLACES = None       # no TPU kernel: launch latency bounds the plain ops
MAX_THREADS = 512     # the kernel's CTA at most ...
MAX_VECS = 4          # ... and the 16-byte vectors each thread holds

launches = 0          # kernel launches since the last reset


def _itemsize(dtype: str) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4}[dtype]


def cost(*, rows: int, dim: int, residual: bool = False,
         dtype: str = "bfloat16"):
    """(operations, bytes, peak dtype) of one call on (rows, dim): x and w
    read once and h written once, with a residual also the residual read
    and s written once; per element the square, its sum, the two
    products and, with a residual, the add (float32 on the CUDA cores)."""
    it = _itemsize(dtype)
    n = rows * dim
    nbytes = (2 * n + dim) * it + (2 * n * it if residual else 0)
    return n * (4 + (1 if residual else 0)), nbytes, "float32"


def rms_norm_plain(x, w, eps: float, residual=None):
    """The plain version, ``models/layers.py``'s ``rms_norm``: h =
    rms_norm(x), or, with ``residual``, the rounded sum s = residual + x
    and (s, rms_norm(s))."""
    if residual is None:
        return _norm(w, x, eps)
    s = residual + x
    return s, _norm(w, s, eps)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"rms_norm kernel: {msg}")


def check_args(x, w, residual=None) -> None:
    """Raise ValueError unless the kernel takes these operands (their
    device aside): the dtypes, shapes, strides and alignment above."""
    _require(x.dtype in (torch.bfloat16, torch.float32),
             f"x must be bfloat16 or float32, got {x.dtype}")
    _require(x.dim() >= 1, "x needs a last dim")
    D = x.shape[-1]
    vec = 16 // x.element_size()
    _require(D > 0 and D % vec == 0,
             f"D={D} is not a positive multiple of {vec}")
    _require(D // vec <= MAX_THREADS * MAX_VECS,
             f"D={D} is over {MAX_THREADS * MAX_VECS * vec}")
    _require(w.dtype == x.dtype and w.shape == (D,),
             f"w must be ({D},) {x.dtype}, got {tuple(w.shape)} {w.dtype}")
    operands = [(x, "x"), (w, "w")]
    if residual is not None:
        _require(residual.dtype == x.dtype and residual.shape == x.shape,
                 f"residual must be {tuple(x.shape)} {x.dtype}, got "
                 f"{tuple(residual.shape)} {residual.dtype}")
        operands.append((residual, "residual"))
    for t, name in operands:
        _require(t.is_contiguous(), f"{name} must be contiguous")
        _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")


def rms_norm(x, w, eps: float, residual=None):
    """x: (..., D); w: (D,) -> h, or (s, h) with ``residual`` (like x).

    CPU tensors run ``rms_norm_plain``; CUDA tensors launch the kernel or
    raise."""
    if not x.is_cuda:
        return rms_norm_plain(x, w, eps, residual)
    global launches
    check_args(x, w, residual)
    dev = x.device
    for t, name in ((w, "w"), (residual, "residual")):
        _require(t is None or t.device == dev, f"{name} must be on {dev}")
    h = torch.empty_like(x)
    s = None if residual is None else torch.empty_like(x)
    D = x.shape[-1]
    err = build.load().pb_rms_norm(
        build.dtype_code(x.dtype), dev.index, x.data_ptr(),
        build.ptr(residual), w.data_ptr(), h.data_ptr(), build.ptr(s),
        x.numel() // D, D, float(eps), build.stream_of(x))
    build.check(err, "rms_norm")
    launches += 1
    return h if s is None else (s, h)
