"""The Mamba-2 decode step's state update and readout, in place: the CUDA
kernel's wrapper, its launch count and its plain PyTorch version.

Replaces no TPU kernel: the JAX package leaves the recurrent decode step
to XLA, which fuses it.  It was added because the port's decode step ran
it as plain PyTorch over the float32 state S (B x H x P x N; 512 MiB a
layer for granite-4.0-h-small at 128 slots): the outer product, the
decay, the sum, the readout and the cache's copy read and wrote about
nine S a layer where one read and one write are needed.

On the H100 the work is bound by its bytes (the state read and written
once; x, dt, B, C and the per-head parameters read once and y written
once: 5 float32 operations per 8 bytes of state).  The kernel
(``csrc/ssm_step.cu``) runs a CTA a (row, head) tile, 3 CTAs an SM, each
warp holding 8 rows of 16-byte state vectors in flight (streaming loads
and stores), and sums each row's readout by shuffles.  Every product and
sum of the state is rounded on its own in the plain version's order,
with precise ``expf``/``log1pf``: the state equals the plain version's
where its outer product takes (dt x) B first (the order ``torch.einsum``
takes with opt_einsum at P < N); the readout sums in another order before
its bf16 rounding.

Layouts: state (B, H, P, N) float32, contiguous, 16-byte aligned, N a
multiple of 4 and at most 256; x (B, H, P), raw dt (B, H), Bm and Cm (B,
N) any strides, one dtype (bfloat16 or float32); dt_bias, A_log and
D_skip (H,) float32 contiguous.  Returns y (B, H, P) in x's dtype and
updates ``state`` in place.  The wrapper runs the kernel for CUDA tensors
(or raises) and the plain version for CPU tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/csrc/ssm_step.cu"
REPLACES = None       # no TPU kernel: the plain ops move the state ~9 times
MAX_STATE = 256       # N: two 16-byte vectors a lane at most
MAX_TILES = 2 ** 31 - 1   # the grid holds a CTA per (row, head) in grid.x

launches = 0          # kernel launches since the last reset


def _itemsize(dtype: str) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4}[dtype]


def cost(*, batch: int, heads: int, head_dim: int, state: int,
         dtype: str = "bfloat16"):
    """(operations, bytes, peak dtype) of one call: the float32 state read
    once and written once, x read and y written once, dt, B and C read
    once, dt_bias, A_log and D_skip read once; per state element the
    decay's product, the input's product, their sum and the readout's
    product and sum (float32 on the CUDA cores)."""
    it = _itemsize(dtype)
    n = batch * heads * head_dim * state
    nbytes = (2 * n * 4 + 2 * batch * heads * head_dim * it
              + batch * heads * it + 2 * batch * state * it + 3 * heads * 4)
    return 5 * n, nbytes, "float32"


def ssm_step_plain(state, x, dt, dt_bias, A_log, Bm, Cm, D_skip):
    """The plain version, ``models/mamba2.py``'s ``mixer_step`` lines as
    they were: the new state written over ``state`` at the end; returns
    y (B, H, P) in x's dtype."""
    B = Bm.float()
    C = Cm.float()
    dt = F.softplus(dt.float() + dt_bias)                        # (B,H)
    A = -torch.exp(A_log)
    dA = torch.exp(dt * A)                                       # (B,H)
    # h_new = dA * h + dt * B (outer) x
    dBx = torch.einsum("bh,bn,bhp->bhpn", dt, B, x.float())
    new_state = state * dA[..., None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", C, new_state).to(x.dtype)
    y = y + D_skip.to(y.dtype)[:, None] * x
    state.copy_(new_state)
    return y


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ssm_step kernel: {msg}")


def check_args(state, x, dt, dt_bias, A_log, Bm, Cm, D_skip) -> None:
    """Raise ValueError unless the kernel takes these operands (their
    device aside): the dtypes, shapes, strides and alignment above."""
    _require(x.dtype in (torch.bfloat16, torch.float32),
             f"x must be bfloat16 or float32, got {x.dtype}")
    _require(x.dim() == 3, f"x {tuple(x.shape)} must be (B, H, P)")
    B, H, P = x.shape
    for t, name in ((dt, "dt"), (Bm, "Bm"), (Cm, "Cm")):
        _require(t.dtype == x.dtype, f"{name} must be {x.dtype}, got "
                 f"{t.dtype}")
    _require(tuple(dt.shape) == (B, H),
             f"dt {tuple(dt.shape)} must be ({B}, {H})")
    _require(Bm.dim() == 2 and Bm.shape[0] == B
             and Cm.shape == Bm.shape, f"Bm {tuple(Bm.shape)} and Cm "
             f"{tuple(Cm.shape)} must be ({B}, N)")
    N = Bm.shape[1]
    _require(0 < N <= MAX_STATE and N % 4 == 0,
             f"N={N} is not a positive multiple of 4 up to {MAX_STATE}")
    _require(B * H <= MAX_TILES, f"{B} x {H} tiles > {MAX_TILES}")
    for t, name in ((dt_bias, "dt_bias"), (A_log, "A_log"),
                    (D_skip, "D_skip")):
        _require(t.dtype == torch.float32 and tuple(t.shape) == (H,)
                 and t.is_contiguous(),
                 f"{name} must be a contiguous ({H},) float32 tensor")
    _require(state.dtype == torch.float32
             and tuple(state.shape) == (B, H, P, N),
             f"state must be ({B}, {H}, {P}, {N}) float32, got "
             f"{tuple(state.shape)} {state.dtype}")
    _require(state.is_contiguous(), "state must be contiguous")
    _require(state.data_ptr() % 16 == 0, "state must be 16-byte aligned")


def ssm_step(state, x, dt, dt_bias, A_log, Bm, Cm, D_skip):
    """state (B, H, P, N) float32, updated in place; x (B, H, P); raw dt
    (B, H); dt_bias, A_log, D_skip (H,) float32; Bm, Cm (B, N) -> y (B,
    H, P) in x's dtype.

    CPU tensors run ``ssm_step_plain``; CUDA tensors launch the kernel or
    raise."""
    if not x.is_cuda:
        return ssm_step_plain(state, x, dt, dt_bias, A_log, Bm, Cm, D_skip)
    global launches
    check_args(state, x, dt, dt_bias, A_log, Bm, Cm, D_skip)
    dev = x.device
    for t, name in ((state, "state"), (dt, "dt"), (dt_bias, "dt_bias"),
                    (A_log, "A_log"), (Bm, "Bm"), (Cm, "Cm"),
                    (D_skip, "D_skip")):
        _require(t.device == dev, f"{name} must be on {dev}")
    B, H, P, N = state.shape
    y = torch.empty((B, H, P), dtype=x.dtype, device=dev)
    err = build.load().pb_ssm_step(
        build.dtype_code(x.dtype), dev.index, state.data_ptr(),
        x.data_ptr(), dt.data_ptr(), dt_bias.data_ptr(), A_log.data_ptr(),
        Bm.data_ptr(), Cm.data_ptr(), D_skip.data_ptr(), y.data_ptr(),
        build.strides((x, (0, 1, 2)), (dt, (0, 1)), (Bm, (0, 1)),
                      (Cm, (0, 1))), B, H, P, N, build.stream_of(x))
    build.check(err, "ssm_step")
    launches += 1
    return y
