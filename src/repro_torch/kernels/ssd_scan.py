"""Mamba-2 SSD chunked scan: the CUDA kernel's wrapper, its launch count
and its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/ssd_scan.py``
(``ssd_scan`` / ``_ssd_kernel``), the state-space-duality scan of
[arXiv:2405.21060]: per chunk, the masked quadratic form
(C Bᵀ ∘ exp(segsum(dt·A)) ∘ dt, causal)·x plus exp(cum)·C·state, with the
(P, N) float32 state carried from chunk to chunk.  It is the prefill of
every SSM layer, i.e. the compute behind a Mamba-2 model's time to first
token.

On the H100, at a serving prefill, the bytes bound it (a few
microseconds for x, y, B, C, dt and the final state).  The kernel
(``csrc/ssd_scan.cu``) walks the chunks of one (row, head, 32 columns of
P) inside one CTA with the state in shared memory, and does the products
on the CUDA cores in float32: right first, far above that bound.

Layouts: x (B, S, H, P) in the model dtype; dt (B, S, H) float32 (after
softplus); A (H,) float32, negative; Bm/Cm (B, S, N) in x's dtype; an
optional initial state (B, H, P, N) float32 -> y (B, S, H, P) in x's
dtype, final state (B, H, P, N) float32.  x, Bm and Cm may be strided
views (slices of one ``conv_out`` tensor): the kernel reads any strides
with the last dimension contiguous, so nothing is copied.  The wrapper
runs the kernel for CUDA tensors (or raises) and the plain version for
CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
REPLACES = "src/repro/kernels/ssd_scan.py:90"
CHUNK = 64            # the kernel's chunk length
P_BLOCK = 32          # columns of P per CTA: P must be a multiple
MAX_STATE = 128       # largest N the kernel's shared memory holds

launches = 0          # kernel launches since the last reset


def ssd_scan_plain(x, dt, A, Bm, Cm, initial_state=None, *,
                   chunk: int = CHUNK):
    """The plain version: ``_ssd_kernel``'s chunk loop in float32, over
    all rows and heads at once, from ``initial_state`` (B, H, P, N) or
    zeros.  A short last chunk is computed at its true length, which
    equals the reference's dt = 0 padding exactly."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    a = A.float()
    y = torch.empty((Bsz, S, H, P), dtype=f32, device=x.device)
    state = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
             if initial_state is None else initial_state.to(f32).clone())
    for t0 in range(0, S, chunk):
        xc = x[:, t0:t0 + chunk].float()                # (B, Q, H, P)
        dtc = dt[:, t0:t0 + chunk].float()              # (B, Q, H)
        bc = Bm[:, t0:t0 + chunk].float()               # (B, Q, N)
        cc = Cm[:, t0:t0 + chunk].float()
        Q = xc.shape[1]
        cum = torch.cumsum(dtc * a, dim=1)              # (B, Q, H)
        causal = torch.ones((Q, Q), dtype=torch.bool,
                            device=x.device).tril()[None, :, :, None]
        # exp only inside the causal mask: above it the exponent is
        # positive and may overflow
        seg = (cum[:, :, None, :] - cum[:, None, :, :]).masked_fill(
            ~causal, float("-inf"))                     # (B, Q, K, H)
        scores = torch.einsum("bqn,bkn->bqk", cc, bc)
        G = scores[..., None] * torch.exp(seg) * dtc[:, None, :, :]
        yc = torch.einsum("bqkh,bkhp->bqhp", G, xc)
        yc = yc + torch.exp(cum)[..., None] * torch.einsum(
            "bqn,bhpn->bqhp", cc, state)
        w = torch.exp(cum[:, -1:, :] - cum) * dtc       # (B, Q, H)
        state = (torch.exp(cum[:, -1, :])[..., None, None] * state
                 + torch.einsum("bkhp,bkn->bhpn", xc * w[..., None], bc))
        y[:, t0:t0 + Q] = yc
    return y.to(x.dtype), state


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ssd_scan kernel: {msg}")


def ssd_scan(x, dt, A, Bm, Cm, initial_state=None):
    """x: (B, S, H, P); dt: (B, S, H); A: (H,); Bm/Cm: (B, S, N);
    initial_state: (B, H, P, N) or None (zeros) -> (y (B, S, H, P), final
    state (B, H, P, N) float32).

    CPU tensors run ``ssd_scan_plain``; CUDA tensors launch the kernel or
    raise."""
    if not x.is_cuda:
        return ssd_scan_plain(x, dt, A, Bm, Cm, initial_state)
    global launches
    _require(x.dim() == 4, f"x must be (B, S, H, P), got {tuple(x.shape)}")
    Bsz, S, H, P = x.shape
    _require(dt.shape == (Bsz, S, H), f"dt {tuple(dt.shape)} does not "
             f"match x {tuple(x.shape)}")
    _require(A.shape == (H,), f"A {tuple(A.shape)} is not ({H},)")
    _require(Bm.dim() == 3 and Bm.shape[:2] == (Bsz, S)
             and Cm.shape == Bm.shape, f"Bm {tuple(Bm.shape)} / Cm "
             f"{tuple(Cm.shape)} do not match x {tuple(x.shape)}")
    N = Bm.shape[-1]
    _require(P % P_BLOCK == 0, f"head dim P={P} is not a multiple of "
             f"{P_BLOCK}")
    _require(1 <= N <= MAX_STATE, f"state size N={N} not in "
             f"[1, {MAX_STATE}]")
    dev, dtype = x.device, x.dtype
    code = build.dtype_code(dtype)
    for t, name in ((x, "x"), (Bm, "Bm"), (Cm, "Cm")):
        _require(t.is_cuda and t.device == dev, f"{name} must be on {dev}")
        _require(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
        _require(t.stride(-1) == 1, f"{name} needs a contiguous last dim")
    for t, name in ((dt, "dt"), (A, "A")):
        _require(t.is_cuda and t.device == dev, f"{name} must be on {dev}")
        _require(t.dtype == torch.float32,
                 f"{name} must be float32, got {t.dtype}")
    _require(A.is_contiguous(), "A must be contiguous")
    h0 = None
    if initial_state is not None:
        _require(initial_state.is_cuda and initial_state.device == dev,
                 f"initial_state must be on {dev}")
        _require(initial_state.dtype == torch.float32
                 and initial_state.shape == (Bsz, H, P, N),
                 f"initial_state must be float32 {(Bsz, H, P, N)}, got "
                 f"{initial_state.dtype} {tuple(initial_state.shape)}")
        h0 = initial_state.contiguous()
    y = torch.empty((Bsz, S, H, P), dtype=dtype, device=dev)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
    st = build.strides((x, (0, 1, 2)), (dt, (0, 1, 2)), (Bm, (0, 1)),
                       (Cm, (0, 1)), (y, (0, 1, 2)))
    err = build.load().pb_ssd_scan(
        code, dev.index, x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
        build.ptr(h0), st, Bsz, S, H, P, N, build.stream_of(x))
    build.check(err, "ssd_scan")
    launches += 1
    return y, state
