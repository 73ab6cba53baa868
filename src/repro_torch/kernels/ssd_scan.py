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
(``csrc/ssd_scan.cu``) runs the chunked decomposition of
[arXiv:2405.21060] §6 parallel over the chunks, in three launches chained
as programmatic dependents: (1) each chunk's state contribution from a
zero state, one CTA per (row, chunk, head, block of P), and C Bᵀ once
per (row, chunk); (2) a pass over the chunks that turns the contributions
into the state entering each chunk and the final state; (3) each chunk's
outputs from its entering state.  bf16 products run on the tensor cores
(``mma.sync``), with each float32 operand split into two bf16 parts;
float32 products stay on the CUDA cores.  ``launches`` counts one per
wrapper call.  ``ssd_scan_plain(..., phases=True)`` emulates the three
phases on the CPU (``ssd_chunk_states``, ``ssd_state_pass``,
``ssd_chunk_outputs``).

Layouts: x (B, S, H, P) in the model dtype; dt (B, S, H) float32 (after
softplus); A (H,) float32, negative; Bm/Cm (B, S, N) in x's dtype; an
optional initial state (B, H, P, N) float32 -> y (B, S, H, P) in x's
dtype, final state (B, H, P, N) float32.  x, Bm and Cm may be strided
views (slices of one ``conv_out`` tensor): the kernel reads any strides
with the last dimension contiguous, so nothing is copied.  The wrapper
runs the kernel for CUDA tensors (or raises) and the plain version for
CPU tensors.

Gradients: where autograd records the call, the wrapper runs the kernel
inside ``function(launch)``, a ``torch.autograd.Function`` whose backward
(``ssd_scan_backward``) runs the plain version again from the saved inputs
and differentiates it, for x, dt, A, B, C and the initial state.  The
reference has no backward kernel either.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
REPLACES = "src/repro/kernels/ssd_scan.py:90"
CHUNK = 64            # the kernel's chunk length
P_BLOCK = 32          # columns of P per CTA: P must be a multiple
MAX_STATE = 128       # largest N the kernel's shared memory holds

launches = 0          # kernel launches since the last reset


def cost(*, batch: int, seq: int, heads: int, head_dim: int, state: int,
         dtype: str = "bfloat16", initial_state: bool = False,
         grad: bool = False):
    """(operations, bytes, peak dtype) of one scan: x, dt, A, B and C read
    once (x, B, C in ``dtype``, dt and A float32), y written once in
    ``dtype`` and the float32 final state once (the initial state read
    once when given).  Operations, per chunk of ``CHUNK`` rows: the
    causal pairs of C Bᵀ once, and per head G x over the pairs, the
    state's read C h and its update xᵀ B.  The products run on the
    tensor cores in bf16 (float32 operands split in two bf16 parts, whose
    extra products the inputs do not need), so the bf16 peak applies.
    ``grad``: the backward, which reads the inputs and dy and writes their
    gradients, at twice the forward's products."""
    it = 2 if dtype in ("bfloat16", "float16") else 4
    x = batch * seq * heads * head_dim * it
    inputs = (x + batch * seq * heads * 4 + heads * 4
              + 2 * batch * seq * state * it)
    st = batch * heads * head_dim * state * 4
    flops = 0
    for t0 in range(0, seq, CHUNK):
        q = min(CHUNK, seq - t0)
        pairs = q * (q + 1) // 2
        flops += batch * (2 * state * pairs
                          + heads * (2 * head_dim * pairs
                                     + 4 * q * head_dim * state))
    h0 = st if initial_state else 0
    if grad:
        return 2 * flops, 2 * inputs + x + st + 2 * h0, "bfloat16"
    return flops, inputs + x + st + h0, "bfloat16"


def ssd_scan_plain(x, dt, A, Bm, Cm, initial_state=None, *,
                   chunk: int = CHUNK, phases: bool = False):
    """The plain version: ``_ssd_kernel``'s chunk loop in float32, over
    all rows and heads at once, from ``initial_state`` (B, H, P, N) or
    zeros.  A short last chunk is computed at its true length, which
    equals the reference's dt = 0 padding exactly.  ``phases=True`` runs
    the kernel's three phases instead (``ssd_chunk_states``,
    ``ssd_state_pass``, ``ssd_chunk_outputs``)."""
    if phases:
        s, decay = ssd_chunk_states(x, dt, A, Bm, chunk=chunk)
        entering, final = ssd_state_pass(s, decay, initial_state)
        return ssd_chunk_outputs(x, dt, A, Bm, Cm, entering,
                                 chunk=chunk), final
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


def _chunked(t, chunk: int):
    """(B, S, ...) -> (B, nc, chunk, ...) float32, zero rows past S (with
    dt = 0 they are an exact no-op on the recurrence)."""
    S = t.shape[1]
    nc = -(-S // chunk)
    t = t.float()
    pad = nc * chunk - S
    if pad:
        t = torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])], 1)
    return t.reshape((t.shape[0], nc, chunk) + t.shape[2:])


def _chunk_cumsum(dt, A, chunk: int):
    dtc = _chunked(dt, chunk)                           # (B, nc, Q, H)
    return dtc, torch.cumsum(dtc * A.float(), dim=2)


def ssd_chunk_states(x, dt, A, Bm, *, chunk: int = CHUNK):
    """Phase 1: each chunk's contribution to the state from a zero state,
    s_c = sum_k exp(cum_last - cum_k) dt_k x_k B_kᵀ (B, nc, H, P, N), and
    its decay exp(cum_last) (B, nc, H)."""
    dtc, cum = _chunk_cumsum(dt, A, chunk)
    w = torch.exp(cum[:, :, -1:] - cum) * dtc           # (B, nc, Q, H)
    s = torch.einsum("bckhp,bckn->bchpn", _chunked(x, chunk) * w[..., None],
                     _chunked(Bm, chunk))
    return s, torch.exp(cum[:, :, -1])


def ssd_state_pass(s, decay, initial_state=None):
    """Phase 2: the state entering each chunk (B, nc, H, P, N) and the
    final state, S_0 = initial_state (or zeros), S_{c+1} = decay_c S_c +
    s_c."""
    Bsz, nc, H, P, N = s.shape
    S = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=s.device)
         if initial_state is None else initial_state.float())
    entering = torch.empty_like(s)
    for c in range(nc):
        entering[:, c] = S
        S = decay[:, c, :, None, None] * S + s[:, c]
    return entering, S


def ssd_chunk_outputs(x, dt, A, Bm, Cm, entering, *, chunk: int = CHUNK):
    """Phase 3: y = G x + exp(cum_q) C S_inᵀ per chunk, with G = C Bᵀ ∘
    exp(cum_q - cum_k) ∘ dt_k where q >= k, from the entering states."""
    Bsz, S, H, P = x.shape
    dtc, cum = _chunk_cumsum(dt, A, chunk)
    cc = _chunked(Cm, chunk)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()[:, :, None]
    seg = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).masked_fill(
        ~causal, float("-inf"))                         # (B, nc, Q, K, H)
    cb = torch.einsum("bcqn,bckn->bcqk", cc, _chunked(Bm, chunk))
    G = cb[..., None] * torch.exp(seg) * dtc[:, :, None, :, :]
    y = torch.einsum("bcqkh,bckhp->bcqhp", G, _chunked(x, chunk))
    y = y + torch.exp(cum)[..., None] * torch.einsum(
        "bcqn,bchpn->bcqhp", cc, entering)
    return y.reshape(Bsz, -1, H, P)[:, :S].to(x.dtype)


def p_block(B: int, S: int, H: int, P: int, dtype, sms: int) -> int:
    """Columns of P a CTA of the chunk kernels takes: 64 in bf16 where P
    allows it and the chunk kernels still have a CTA for each of the
    card's ``sms`` SMs (half the CTAs, each re-reading the chunk's B or C
    tile), else ``P_BLOCK`` (more CTAs for a short prompt)."""
    ctas = B * -(-S // CHUNK) * H * (P // 64)
    return (64 if dtype == torch.bfloat16 and P % 64 == 0 and ctas >= sms
            else P_BLOCK)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ssd_scan kernel: {msg}")


def ssd_scan_backward(inputs, dy, dstate, needs):
    """The gradients of ``ssd_scan`` at ``inputs`` = (x, dt, A, Bm, Cm,
    initial_state or None) for the output gradients (dy, dstate): the
    plain version run again from the inputs (detached; x, Bm and Cm keep
    their strides) and differentiated by autograd.  ``needs`` says for
    each input whether its gradient is wanted; the others get None."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(bool(n))
                  for t, n in zip(inputs, needs)]
        y, state = ssd_scan_plain(*leaves)
        wanted = [t for t in leaves if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad((y, state), wanted, (dy, dstate)))
    return tuple(next(grads) if t is not None and t.requires_grad else None
                 for t in leaves)


def function(forward):
    """A ``torch.autograd.Function`` over ``forward`` (the kernel's launch
    on the card; the CPU tests pass ``ssd_scan_plain``): the forward is
    ``forward`` unchanged, the backward ``ssd_scan_backward``.  A second
    derivative raises (``once_differentiable``)."""

    class SSDScan(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, dt, A, Bm, Cm, initial_state):
            ctx.save_for_backward(x, dt, A, Bm, Cm, initial_state)
            return forward(x, dt, A, Bm, Cm, initial_state)

        @staticmethod
        @once_differentiable
        def backward(ctx, dy, dstate):
            return ssd_scan_backward(ctx.saved_tensors, dy, dstate,
                                     ctx.needs_input_grad)

    return SSDScan


def ssd_scan(x, dt, A, Bm, Cm, initial_state=None):
    """x: (B, S, H, P); dt: (B, S, H); A: (H,); Bm/Cm: (B, S, N);
    initial_state: (B, H, P, N) or None (zeros) -> (y (B, S, H, P), final
    state (B, H, P, N) float32).

    CPU tensors run ``ssd_scan_plain``; CUDA tensors launch the kernel or
    raise, inside the autograd Function where autograd records the
    call."""
    if not x.is_cuda:
        return ssd_scan_plain(x, dt, A, Bm, Cm, initial_state)
    if build.needs_grad(x, dt, A, Bm, Cm, initial_state):
        return _Kernel.apply(x, dt, A, Bm, Cm, initial_state)
    return _launch(x, dt, A, Bm, Cm, initial_state)


def _launch(x, dt, A, Bm, Cm, initial_state=None):
    """The kernel's launch: checks the inputs, counts the launch."""
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
    # chunk states (B, nc, H, P, N), C Bᵀ (B, nc, 64, 64), decays (B, nc, H)
    nc = -(-S // CHUNK)
    ws = torch.empty((Bsz * nc * (H * P * N + CHUNK * CHUNK + H),),
                     dtype=torch.float32, device=dev)
    st = build.strides((x, (0, 1, 2)), (dt, (0, 1, 2)), (Bm, (0, 1)),
                       (Cm, (0, 1)), (y, (0, 1, 2)))
    err = build.load().pb_ssd_scan(
        code, dev.index, x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
        build.ptr(h0), ws.data_ptr(), st, Bsz, S, H, P, N,
        p_block(Bsz, S, H, P, dtype,
                torch.cuda.get_device_properties(dev).multi_processor_count),
        build.stream_of(x))
    build.check(err, "ssd_scan")
    launches += 1
    return y, state


_Kernel = function(_launch)
