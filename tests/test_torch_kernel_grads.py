"""The backward of the three kernels on the train path (flash attention,
the SSD scan, the RG-LRU scan), run on the CPU with each kernel's plain
version standing in for its launch: ``<module>.function(plain)`` is the
same ``torch.autograd.Function`` the wrappers apply on the card around
the launch.  Each gradient is held against autograd through the plain
version itself, in float64 inputs where the kernel's math is float32, so
only float32 sum order separates them: within 1e-5 of the largest
gradient of each input (flash and RG-LRU), 1e-6 for the SSD scan, whose
backward is autograd through the same plain version again.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import ssd_scan as ssd

FLASH_TOL = 1e-5
SSD_TOL = 1e-6
RGLRU_TOL = 1e-5


def _close(got, want, tol, what):
    scale = max(want.abs().max().item(), 1e-30)
    err = (got.double() - want.double()).abs().max().item()
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _grads(fn, inputs, grads_out):
    """d(sum <out_i, grads_out_i>)/d inputs."""
    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    wanted = [t for t in inputs if t is not None and t.requires_grad]
    return torch.autograd.grad(outs, wanted, grads_out)


@pytest.mark.parametrize("spec", [
    # (B, Sq, Sk, Hq, Hkv, d, kw)
    (2, 37, 37, 4, 4, 64, {}),
    (2, 37, 37, 4, 4, 64, {"window": 9}),
    (1, 40, 40, 4, 4, 80, {"causal": False}),
    (1, 40, 40, 4, 4, 80, {"causal": False, "window": 7}),
    (2, 33, 33, 6, 2, 128, {}),                         # GQA 3 on 1
    (1, 12, 45, 4, 1, 64, {"q_offset": 33}),            # continued prefill
    (1, 12, 45, 4, 2, 128, {"q_offset": 33, "window": 10}),
], ids=["causal", "window", "d80-noncausal", "d80-noncausal-window",
        "gqa-d128", "q_offset", "q_offset-window-gqa"])
def test_flash_backward_matches_autograd_of_plain(spec):
    B, Sq, Sk, Hq, Hkv, d, kw = spec
    g = torch.Generator().manual_seed(3)
    q, k, v = [torch.randn(s, generator=g, dtype=torch.float64)
               .requires_grad_() for s in ((B, Hq, Sq, d), (B, Hkv, Sk, d),
                                           (B, Hkv, Sk, d))]
    dout = torch.randn((B, Hq, Sq, d), generator=g, dtype=torch.float64)
    fn = fa.function(fa.flash_attention_plain)

    def through_function(q, k, v):
        return fn.apply(q, k, v, kw.get("causal", True), kw.get("window", 0),
                        kw.get("q_offset", 0), None)

    def through_plain(q, k, v):
        return fa.flash_attention_plain(q, k, v, block_q=16, block_k=16,
                                        **kw)

    got = _grads(through_function, (q, k, v), (dout,))
    want = _grads(through_plain, (q, k, v), (dout,))
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.float64 and a.shape == b.shape
        _close(a, b, FLASH_TOL, f"d{name}")
    assert max(t.abs().max().item() for t in got) > 0


def test_flash_backward_blocks_and_dtype():
    """The query-block loop and a bf16 input: the same gradients at any
    ``block_q``, in the inputs' dtypes."""
    g = torch.Generator().manual_seed(4)
    q, k, v = [torch.randn(s, generator=g) for s in
               ((1, 4, 50, 64), (1, 2, 50, 64), (1, 2, 50, 64))]
    dout = torch.randn((1, 4, 50, 64), generator=g)
    one = fa.flash_attention_backward(q, k, v, dout, window=20,
                                      block_q=512)
    blocked = fa.flash_attention_backward(q, k, v, dout, window=20,
                                          block_q=16)
    for a, b in zip(one, blocked):
        _close(a, b, 1e-6, "block_q")
    bf = [t.bfloat16() for t in (q, k, v, dout)]
    for t in fa.flash_attention_backward(*bf, window=20):
        assert t.dtype == torch.bfloat16


def _ssd_inputs(g, B, S, H, P, N, with_state, dtype=torch.float64):
    """x, B and C as strided slices of one conv_out, as the model passes
    them."""
    conv_out = torch.randn((B, S, H * P + 2 * N), generator=g, dtype=dtype)
    conv_out.requires_grad_()
    x = conv_out[..., :H * P].reshape(B, S, H, P)
    Bm = conv_out[..., H * P:H * P + N]
    Cm = conv_out[..., H * P + N:]
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, dtype=dtype)).requires_grad_()
    A = (-torch.linspace(1.0, 4.0, H, dtype=dtype)).requires_grad_()
    h0 = (torch.randn((B, H, P, N), generator=g, dtype=dtype)
          .requires_grad_() if with_state else None)
    return conv_out, (x, dt, A, Bm, Cm, h0)


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["from-zeros", "from-state"])
def test_ssd_backward_matches_autograd_of_plain(with_state):
    g = torch.Generator().manual_seed(5)
    B, S, H, P, N = 2, 70, 3, 4, 5           # a short last chunk of 6
    conv_out, inputs = _ssd_inputs(g, B, S, H, P, N, with_state)
    dy = torch.randn((B, S, H, P), generator=g, dtype=torch.float64)
    dst = torch.randn((B, H, P, N), generator=g, dtype=torch.float64)
    fn = ssd.function(ssd.ssd_scan_plain)
    leaves = [conv_out] + [t for t in inputs[1:] if t is not None
                           and t.is_leaf]
    outs_f = fn.apply(*inputs)
    got = torch.autograd.grad(outs_f, leaves, (dy, dst))
    _, inputs2 = _ssd_inputs(torch.Generator().manual_seed(5), B, S, H, P,
                             N, with_state)
    outs_p = ssd.ssd_scan_plain(*inputs2)
    leaves2 = [inputs2[0]._base] + [t for t in inputs2[1:] if t is not None
                                    and t.is_leaf]
    want = torch.autograd.grad(outs_p, leaves2, (dy, dst))
    names = ["conv_out (x, B, C)", "dt", "A"] + (["h0"] if with_state
                                                   else [])
    assert len(got) == len(names)
    for name, a, b in zip(names, got, want):
        _close(a, b, SSD_TOL, f"d{name}")
        assert a.abs().max().item() > 0, name


def test_ssd_backward_only_what_is_asked():
    """Inputs that need no gradient get None, and the saved strided views
    keep their layout."""
    g = torch.Generator().manual_seed(6)
    _, (x, dt, A, Bm, Cm, _) = _ssd_inputs(g, 1, 20, 2, 4, 3, False)
    x, Bm, Cm = x.detach(), Bm.detach(), Cm.detach()
    dy = torch.randn(x.shape, generator=g, dtype=torch.float64)
    dst = torch.zeros((1, 2, 4, 3), dtype=torch.float64)
    out = ssd.ssd_scan_backward((x, dt, A, Bm, Cm, None), dy, dst,
                                (False, True, False, False, False, False))
    assert out[0] is None and out[2] is None and out[5] is None
    assert out[1].shape == dt.shape


def _rglru_inputs(g, B, S, W, with_h0):
    r = torch.sigmoid(torch.randn((B, S, W), generator=g,
                                  dtype=torch.float64))
    log_a = (-8.0 * 0.05 * r).requires_grad_()
    bx = torch.randn((B, S, W), generator=g,
                     dtype=torch.float64).requires_grad_()
    h0 = (torch.randn((B, W), generator=g, dtype=torch.float64)
          .requires_grad_() if with_h0 else None)
    return log_a, bx, h0


@pytest.mark.parametrize("with_h0,grad_h_T", [(False, False), (True, False),
                                              (True, True), (False, True)],
                         ids=["zeros", "h0", "h0+dh_T", "zeros+dh_T"])
def test_rglru_reversed_scan_matches_autograd_of_plain(with_h0, grad_h_T):
    g = torch.Generator().manual_seed(7)
    B, S, W = 2, 29, 6
    inputs = _rglru_inputs(g, B, S, W, with_h0)
    dy = torch.randn((B, S, W), generator=g, dtype=torch.float64)
    dhT = (torch.randn((B, W), generator=g, dtype=torch.float64)
           if grad_h_T else torch.zeros((B, W), dtype=torch.float64))
    fn = rg.function(rg.rglru_scan_plain)
    got = _grads(fn.apply, inputs, (dy, dhT))
    want = _grads(rg.rglru_scan_plain, inputs, (dy, dhT))
    for name, a, b in zip(("log_a", "bx", "h0"), got, want):
        _close(a, b, RGLRU_TOL, f"d{name}")
        assert a.abs().max().item() > 0, name


def test_rglru_backward_formula_by_hand():
    """The reversed scan against the recurrence g_t = dy_t + a_{t+1}
    g_{t+1} written out in numpy."""
    rng = np.random.default_rng(8)
    S, W = 9, 3
    log_a = -rng.uniform(0.01, 1.0, size=(1, S, W))
    dy = rng.standard_normal((1, S, W))
    dhT = rng.standard_normal((1, W))
    h0 = rng.standard_normal((1, W))
    a = np.exp(log_a)
    y = np.zeros((1, S, W))
    h = h0.copy()
    for t in range(S):
        h = a[:, t] * h
        y[:, t] = h
    g = np.zeros((1, S, W))
    nxt = dhT
    for t in reversed(range(S)):
        g[:, t] = dy[:, t] + nxt
        nxt = a[:, t] * g[:, t]
    t = {n: torch.from_numpy(v) for n, v in
         (("log_a", log_a), ("dy", dy), ("dhT", dhT), ("h0", h0), ("y", y))}
    dla, dbx, dh0 = rg.rglru_scan_backward(rg.rglru_scan_plain, t["log_a"],
                                           t["h0"], t["y"], t["dy"],
                                           t["dhT"])
    h_prev = np.concatenate([h0[:, None], y[:, :-1]], 1)
    np.testing.assert_allclose(dbx.numpy(), g, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dla.numpy(), g * a * h_prev, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(dh0.numpy(), a[:, 0] * g[:, 0], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("which", ["flash", "ssd", "rglru"])
def test_second_derivative_raises(which):
    """A gradient the backward cannot serve raises; it never returns zeros
    or None."""
    g = torch.Generator().manual_seed(9)
    if which == "flash":
        q, k, v = [torch.randn((1, 2, 8, 64), generator=g,
                               dtype=torch.float64).requires_grad_()
                   for _ in range(3)]
        out = fa.function(fa.flash_attention_plain).apply(q, k, v, True, 0,
                                                          0, None)
        inputs = (q,)
    elif which == "ssd":
        _, inputs = _ssd_inputs(g, 1, 8, 2, 4, 3, False)
        out = ssd.function(ssd.ssd_scan_plain).apply(*inputs)[0]
        inputs = (inputs[1],)
    else:
        inputs = _rglru_inputs(g, 1, 8, 4, False)
        out = rg.function(rg.rglru_scan_plain).apply(*inputs)[0]
        inputs = (inputs[1],)
    (gr,) = torch.autograd.grad(out.square().sum(), inputs,
                                create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(gr.sum(), inputs)
