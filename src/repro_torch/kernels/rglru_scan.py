"""RG-LRU scan: the CUDA kernel's wrapper, its launch count and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/rglru_scan.py``
(``rglru_scan`` / ``_rglru_kernel``), the linear recurrence of the Griffin
/ RecurrentGemma recurrent block [arXiv:2402.19427]:
h_t = exp(log_a_t) * h_{t-1} + bx_t per channel, from an optional h0.  It
is the prefill of every recurrent layer of a hybrid model.

On the H100 the bytes bound it (log_a and bx read once, y written once).
The kernel (``csrc/rglru_scan.cu``) is channel-parallel over (b, w) and
serial over t; each CTA of 32 channels splits time into 32 segments, one
warp each, composes the carries between them through shared memory and
runs each segment again from its carry.

Layouts: log_a, bx (B, S, W) float32 with the channel dimension
contiguous; h0 (B, W) float32 or None (zeros) -> y (B, S, W) float32,
h_T (B, W) float32.  The wrapper runs the kernel for CUDA tensors (or
raises) and the plain version for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/csrc/rglru_scan.cu"
REPLACES = "src/repro/kernels/rglru_scan.py:79"

launches = 0          # kernel launches since the last reset


def rglru_scan_plain(log_a, bx, h0=None):
    """The plain version: the oracle's loop over time in float32,
    h = exp(log_a_t) * h + bx_t, all channels at once."""
    B, S, W = log_a.shape
    f32 = torch.float32
    h = (torch.zeros((B, W), dtype=f32, device=log_a.device)
         if h0 is None else h0.to(f32))
    a = torch.exp(log_a.to(f32))
    bxf = bx.to(f32)
    y = torch.empty((B, S, W), dtype=f32, device=log_a.device)
    for t in range(S):
        h = a[:, t] * h + bxf[:, t]
        y[:, t] = h
    return y, h.clone()


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"rglru_scan kernel: {msg}")


def rglru_scan(log_a, bx, h0=None):
    """log_a, bx: (B, S, W) float32; h0: (B, W) float32 or None (zeros)
    -> (y (B, S, W), h_T (B, W)), both float32.

    CPU tensors run ``rglru_scan_plain``; CUDA tensors launch the kernel
    or raise."""
    if not log_a.is_cuda:
        return rglru_scan_plain(log_a, bx, h0)
    global launches
    _require(log_a.dim() == 3, f"log_a must be (B, S, W), got "
             f"{tuple(log_a.shape)}")
    B, S, W = log_a.shape
    _require(bx.shape == log_a.shape, f"bx {tuple(bx.shape)} does not match "
             f"log_a {tuple(log_a.shape)}")
    _require(S >= 1 and B >= 1 and W >= 1, f"empty shape {(B, S, W)}")
    dev = log_a.device
    for t, name in ((log_a, "log_a"), (bx, "bx")):
        _require(t.is_cuda and t.device == dev, f"{name} must be on {dev}")
        _require(t.dtype == torch.float32,
                 f"{name} must be float32, got {t.dtype}")
        _require(t.stride(-1) == 1, f"{name} needs a contiguous last dim")
    if h0 is not None:
        _require(h0.is_cuda and h0.device == dev, f"h0 must be on {dev}")
        _require(h0.dtype == torch.float32 and h0.shape == (B, W),
                 f"h0 must be float32 {(B, W)}, got {h0.dtype} "
                 f"{tuple(h0.shape)}")
        h0 = h0.contiguous()
    y = torch.empty((B, S, W), dtype=torch.float32, device=dev)
    h_T = torch.empty((B, W), dtype=torch.float32, device=dev)
    st = build.strides((log_a, (0, 1)), (bx, (0, 1)), (y, (0, 1)))
    err = build.load().pb_rglru_scan(
        dev.index, log_a.data_ptr(), bx.data_ptr(), build.ptr(h0),
        y.data_ptr(), h_T.data_ptr(), st, B, S, W, build.stream_of(log_a))
    build.check(err, "rglru_scan")
    launches += 1
    return y, h_T
