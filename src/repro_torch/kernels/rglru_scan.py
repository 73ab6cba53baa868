"""RG-LRU scan: the CUDA kernel's wrapper, its launch count and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/rglru_scan.py``
(``rglru_scan`` / ``_rglru_kernel``), the linear recurrence of the Griffin
/ RecurrentGemma recurrent block [arXiv:2402.19427]:
h_t = exp(log_a_t) * h_{t-1} + bx_t per channel, from an optional h0.  It
is the prefill of every recurrent layer of a hybrid model.

On the H100 the bytes bound it (log_a and bx read once, y written once).
The kernel (``csrc/rglru_scan.cu``) splits time across a thread-block
cluster of ``CLUSTER`` CTAs that owns 32 channels of one row: time runs in
windows (one up to S = 512), rank k takes the k-th chunk of each window
and each of its ``WARPS`` warps one segment of up to ``STEPS`` steps.
Every input of a segment is requested at once into shared memory; each
segment runs from zero to its decay product and end state, each CTA pushes
its aggregate into every CTA of the cluster (distributed shared memory),
and each segment runs again from its carry out of registers, so the inputs
cross HBM once, in one launch.
``rglru_scan_chunked`` runs the same decomposition in PyTorch (for the
tests).

Layouts: log_a, bx (B, S, W) float32 with the channel dimension
contiguous; h0 (B, W) float32 or None (zeros) -> y (B, S, W) float32,
h_T (B, W) float32.  The wrapper runs the kernel for CUDA tensors (or
raises) and the plain version for CPU tensors.

Gradients: where autograd records the call, the wrapper runs the kernel
inside ``function(launch)``, a ``torch.autograd.Function`` whose backward
(``rglru_scan_backward``) is the same recurrence run backwards in time
through the same launch: g_t = dy_t + a_{t+1} g_{t+1} from g_{S-1} =
dy_{S-1} + dh_T is the scan of flip(dy) with decays [0, flip(log_a[1:])]
from h0 = dh_T, flipped back; then d bx = g, d log_a_t = g_t a_t h_{t-1}
and dh0 = a_0 g_0.
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/csrc/rglru_scan.cu"
REPLACES = "src/repro/kernels/rglru_scan.py:79"

# the kernel's geometry (kCluster, kWarps, kSegSteps in csrc/rglru_scan.cu)
CLUSTER = 8           # CTAs of a cluster, ranks along time
WARPS = 4             # segments of a CTA in a window, one warp each
STEPS = 16            # most steps of a segment

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


def rglru_scan_chunked(log_a, bx, h0=None, *, cluster: int = CLUSTER,
                       warps: int = WARPS, steps: int = STEPS):
    """The kernel's decomposition in PyTorch, for the tests: windows of
    ``cluster * warps * n`` steps (n = min(steps, ceil(S / (cluster *
    warps)))), each split into ``cluster`` rank chunks of ``warps``
    segments of n steps.  Each segment runs from zero to its decay product
    P and end state E; a rank's aggregate composes its segments; the carry
    into a segment folds the window's entering state through the ranks
    before it, then through its rank's segments before it, and the segment
    runs again from that carry.  The fold through all ranks enters the next
    window (h0 the first).  Every product and sum in the kernel's order, in
    float32 (the kernel fuses each multiply-add into one rounding)."""
    B, S, W = log_a.shape
    f32 = torch.float32
    la, bxf = log_a.to(f32), bx.to(f32)
    h = (torch.zeros((B, W), dtype=f32, device=log_a.device)
         if h0 is None else h0.to(f32))
    y = torch.empty((B, S, W), dtype=f32, device=log_a.device)
    n = min(steps, -(-S // (cluster * warps)))
    for tw in range(0, S, cluster * warps * n):
        # each segment from zero: [rank][warp] -> (steps, a, bx, P, E)
        segs = []
        for r in range(cluster):
            segs.append([])
            for w in range(warps):
                t0 = tw + (r * warps + w) * n
                ts = range(t0, min(t0 + n, S))
                a = [torch.exp(la[:, t]) for t in ts]
                b = [bxf[:, t] for t in ts]
                p, e = torch.ones_like(h), torch.zeros_like(h)
                for ai, bi in zip(a, b):
                    e = ai * e + bi
                    p = p * ai
                segs[-1].append((ts, a, b, p, e))
        # each rank's aggregate over its segments
        agg = []
        for rank in segs:
            P, E = torch.ones_like(h), torch.zeros_like(h)
            for *_, p, e in rank:
                E = p * E + e
                P = P * p
            agg.append((P, E))
        # the carries, and each segment again from its carry
        for r in range(cluster):
            c_rank = h
            for P, E in agg[:r]:
                c_rank = P * c_rank + E
            for w in range(warps):
                c = c_rank
                for *_, p, e in segs[r][:w]:
                    c = p * c + e
                ts, a, b, _, _ = segs[r][w]
                for t, ai, bi in zip(ts, a, b):
                    c = ai * c + bi
                    y[:, t] = c
        for P, E in agg:
            h = P * h + E
    return y, y[:, -1].clone()


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"rglru_scan kernel: {msg}")


def rglru_scan_backward(forward, log_a, h0, y, dy, dh_T):
    """(d log_a, d bx, dh0 or None) of ``rglru_scan`` at (log_a, h0) with
    outputs y, for the output gradients (dy, dh_T), through ``forward``
    (the kernel's launch, or a plain version) run on the reversed
    recurrence.  In time t = 0..S-1 with a_t = exp(log_a_t): g_t = dy_t +
    a_{t+1} g_{t+1}, g_{S-1} = dy_{S-1} + dh_T, which is ``forward`` of
    log_a' = [0, flip(log_a[:, 1:])] and bx' = flip(dy) from h0 = dh_T,
    flipped back; d bx_t = g_t, d log_a_t = g_t a_t h_{t-1} (h_{-1} = h0,
    or 0) and dh0 = a_0 g_0."""
    f32 = torch.float32
    la = log_a.to(f32)
    la_rev = torch.cat([torch.zeros_like(la[:, :1]), la[:, 1:].flip(1)], 1)
    g, _ = forward(la_rev, dy.to(f32).flip(1).contiguous(),
                   dh_T.to(f32).contiguous())
    g = g.flip(1)
    a = torch.exp(la)
    h_prev = torch.cat([torch.zeros_like(y[:, :1]) if h0 is None
                        else h0.to(f32)[:, None], y[:, :-1].to(f32)], 1)
    dh0 = None if h0 is None else (a[:, 0] * g[:, 0]).to(h0.dtype)
    return ((g * a * h_prev).to(log_a.dtype), g, dh0)


def function(forward):
    """A ``torch.autograd.Function`` over ``forward`` (the kernel's launch
    on the card; the CPU tests pass ``rglru_scan_plain``): the forward is
    ``forward`` unchanged, the backward ``rglru_scan_backward`` through the
    same ``forward``.  A second derivative raises
    (``once_differentiable``)."""

    class RGLRUScan(torch.autograd.Function):
        @staticmethod
        def forward(ctx, log_a, bx, h0):
            y, h_T = forward(log_a, bx, h0)
            ctx.save_for_backward(log_a, h0, y)
            return y, h_T

        @staticmethod
        @once_differentiable
        def backward(ctx, dy, dh_T):
            log_a, h0, y = ctx.saved_tensors
            dla, dbx, dh0 = rglru_scan_backward(forward, log_a, h0, y, dy,
                                                dh_T)
            return dla, dbx, dh0

    return RGLRUScan


def rglru_scan(log_a, bx, h0=None):
    """log_a, bx: (B, S, W) float32; h0: (B, W) float32 or None (zeros)
    -> (y (B, S, W), h_T (B, W)), both float32.

    CPU tensors run ``rglru_scan_plain``; CUDA tensors launch the kernel
    or raise, inside the autograd Function where autograd records the
    call."""
    if not log_a.is_cuda:
        return rglru_scan_plain(log_a, bx, h0)
    if build.needs_grad(log_a, bx, h0):
        return _Kernel.apply(log_a, bx, h0)
    return _launch(log_a, bx, h0)


def _launch(log_a, bx, h0=None):
    """The kernel's launch: checks the inputs, counts the launch."""
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


_Kernel = function(_launch)


def max_active_clusters(device: int, B: int, S: int, W: int) -> int:
    """How many of the kernel's clusters the card holds at once at a
    (B, S, W) launch (``cudaOccupancyMaxActiveClusters``)."""
    n = ctypes.c_int(0)
    build.check(build.load().pb_rglru_max_active_clusters(
        device, B, S, W, ctypes.byref(n)), "rglru_scan occupancy")
    return n.value
