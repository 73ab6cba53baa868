"""Split-half RoPE on a decode step's q and k in one launch: the CUDA
kernel's wrapper, its launch count and its plain PyTorch version.

Replaces no TPU kernel: the JAX package leaves RoPE to XLA, which fuses it
into one loop.  It was added because the captured decode step ran each
RoPE as seventeen small PyTorch kernels (the inverse frequencies rebuilt,
the angles, cos, sin, casts, four products, the sum, the difference, the
concatenation), twice a layer; inside the step's CUDA graph each costs its
launch latency, while q and k at opt-1.3b's decode shapes (32 rows, 32 +
32 heads of 64, bf16) are 256 KB of reads and writes, 0.15 us at 3.35
TB/s.

On the H100 the work is bound by its bytes (q and k read and written
once, the positions and ``inv_freq`` read once), and at decode sizes by
one launch: the kernel (``csrc/rope.cu``) rotates q and k in the same
one, a thread per (row, head, pair), with precise ``cosf``/``sinf`` (the
build has no fast-math flag, as PyTorch's ``cos`` and ``sin`` kernels
have none) and every product, sum and difference rounded on its own in
``models/layers.py``'s ``apply_rope`` order: the plain version's
arithmetic, so the two agree bit for bit where the card's ``cosf`` and
``sinf`` are PyTorch's.

Layouts: q (B, 1, Hq, hd) and k (B, 1, Hkv, hd), any strides over rows
and heads with hd contiguous, one dtype (bfloat16 or float32); positions
(B,) int32; inv_freq (hd/2,) float32 (``models/layers.py``'s
``rope_freqs``) -> new contiguous (q, k).  The wrapper runs the kernel for
CUDA tensors (or raises) and the plain version for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.models.layers import rope_rotate

SOURCE = "src/repro_torch/kernels/csrc/rope.cu"
REPLACES = None       # no TPU kernel: launch latency bounds the plain ops
MAX_ROWS = 65535      # the kernel's grid holds a row per grid.y

launches = 0          # kernel launches since the last reset


def _itemsize(dtype: str) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4}[dtype]


def cost(*, batch: int, heads: int, kv_heads: int, head_dim: int,
         dtype: str = "bfloat16"):
    """(operations, bytes, peak dtype) of one call: q and k read and
    written once, the positions and inverse frequencies read once; per
    element two products and a sum or difference, float32 on the CUDA
    cores (the angles' cos and sin are not counted)."""
    it = _itemsize(dtype)
    n = batch * (heads + kv_heads) * head_dim
    return 3 * n, 2 * n * it + 4 * batch + 4 * (head_dim // 2), "float32"


def rope_qk_plain(q, k, positions, inv_freq):
    """The plain version: ``models/layers.py``'s ``apply_rope`` of q and
    of k (``rope_rotate``, the same composition with the frequencies
    given)."""
    return (rope_rotate(q, positions[:, None], inv_freq),
            rope_rotate(k, positions[:, None], inv_freq))


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"rope kernel: {msg}")


def check_args(q, k, positions, inv_freq) -> None:
    """Raise ValueError unless the kernel takes these operands (their
    device aside): the dtypes, shapes and strides above."""
    _require(q.dtype in (torch.bfloat16, torch.float32),
             f"q must be bfloat16 or float32, got {q.dtype}")
    _require(k.dtype == q.dtype, f"k must be {q.dtype}, got {k.dtype}")
    _require(q.dim() == 4 and k.dim() == 4 and q.shape[1] == 1
             and k.shape[1] == 1, f"q {tuple(q.shape)} and k "
             f"{tuple(k.shape)} must be (B, 1, H, hd)")
    B, _, _, hd = q.shape
    _require(k.shape[0] == B and k.shape[3] == hd,
             f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    _require(hd > 0 and hd % 2 == 0, f"head dim {hd} is not even")
    _require(B <= MAX_ROWS, f"{B} rows > {MAX_ROWS}")
    _require(q.stride(-1) == 1 and k.stride(-1) == 1,
             "q and k need a contiguous head dim")
    _require(positions.dtype == torch.int32 and positions.shape == (B,)
             and positions.is_contiguous(),
             "positions must be a contiguous (B,) int32 tensor")
    _require(inv_freq.dtype == torch.float32
             and inv_freq.shape == (hd // 2,) and inv_freq.is_contiguous(),
             f"inv_freq must be a contiguous ({hd // 2},) float32 tensor")


def rope_qk(q, k, positions, inv_freq):
    """q: (B, 1, Hq, hd); k: (B, 1, Hkv, hd); positions (B,) int32;
    inv_freq (hd/2,) float32 -> (q, k) rotated.

    CPU tensors run ``rope_qk_plain``; CUDA tensors launch the kernel or
    raise."""
    if not q.is_cuda:
        return rope_qk_plain(q, k, positions, inv_freq)
    global launches
    check_args(q, k, positions, inv_freq)
    dev = q.device
    for t, name in ((k, "k"), (positions, "positions"),
                    (inv_freq, "inv_freq")):
        _require(t.device == dev, f"{name} must be on {dev}")
    B, _, Hq, hd = q.shape
    Hkv = k.shape[2]
    qo = torch.empty(q.shape, dtype=q.dtype, device=dev)
    ko = torch.empty(k.shape, dtype=k.dtype, device=dev)
    err = build.load().pb_rope_qk(
        build.dtype_code(q.dtype), dev.index, q.data_ptr(), k.data_ptr(),
        positions.data_ptr(), inv_freq.data_ptr(), qo.data_ptr(),
        ko.data_ptr(), build.strides((q, (0, 2)), (k, (0, 2))), B, Hq, Hkv,
        hd, build.stream_of(q))
    build.check(err, "rope")
    launches += 1
    return qo, ko
