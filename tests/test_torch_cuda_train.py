"""Training through the kernels, on the card: the gradients of the flash,
SSD and RG-LRU kernels (their autograd Functions) against autograd through
the plain versions, a train step through the kernels against one through
``plain_versions()``, and serving after training (the captured decode step
replays the eager one bit for bit with the Functions in place).

Every test here is marked ``cuda`` and skips without a card (decided in
the ``card`` fixture).  Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_train.py

Tolerances, of each input's gradient against the plain run's, relative to
its max |g|: float32 within 1e-4 (the flash and SSD backwards are float32
plain code on both sides and differ by sum order; the RG-LRU backward runs
the kernel, whose float32 scan differs from the plain loop by expf
rounding and its carries); bf16 inputs within 2e-2 (one bf16 rounding of
each gradient, as the bf16 forward's ``ATTN_TOL``).  The reduced train
step in float32: loss within 1e-5 relative, each gradient leaf within 1e-3
of its max |g| (the kernels' float32 outputs differ from the plain
versions' by sum order, and four layers carry that into the gradients).
"""
import pytest
import torch

from repro_torch.configs.base import get_arch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as topt
from repro_torch.training import train as ttrain

pytestmark = pytest.mark.cuda

GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
STEP_GRAD_TOL = 1e-3


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (an H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


def _grads_both(kernel, plain, inputs, seed=1):
    """(kernel run's grads, plain run's grads, kernel launches) of
    sum(out * w) for each output, w random, w.r.t. the inputs that require
    a gradient."""
    wanted = [t for t in inputs if t is not None and t.requires_grad]
    g = _gen(wanted[0].device, seed)
    ops.reset_launch_counts()
    outs = kernel(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    ws = [torch.randn(o.shape, generator=g, device=o.device).to(o.dtype)
          for o in outs]
    got = torch.autograd.grad(outs, wanted, ws)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    p = plain(*inputs)
    p = p if isinstance(p, tuple) else (p,)
    want = torch.autograd.grad(p, wanted, ws)
    return got, want, counts


def _hold(got, want, dtype, what):
    for i, (a, b) in enumerate(zip(got, want)):
        scale = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        assert scale > 0, f"{what} input {i}: zero gradient"
        assert err <= GRAD_TOL[dtype] * scale, \
            f"{what} input {i}: {err} > {GRAD_TOL[dtype]} * {scale}"


FLASH = [   # (B, S, Hq, Hkv, d, causal, window): chip_smoke 10a's shapes
    (4, 512, 32, 32, 64, True, 0),            # opt-1.3b
    (1, 512, 10, 1, 256, True, 128),          # recurrentgemma-2b, window
    (4, 512, 16, 16, 80, False, 0),           # hubert-xlarge
    (1, 512, 16, 16, 128, True, 0),           # qwen2-moe-a2.7b
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spec", FLASH,
                         ids=["opt", "recurrentgemma", "hubert", "qwen2-moe"])
def test_flash_kernel_gradients_match_plain(card, spec, dtype):
    B, S, Hq, Hkv, d, causal, window = spec
    g = _gen(card, 2)
    # model layout (B, S, H, d), the kernel reading transposed views
    q, k, v = [torch.randn((B, S, h, d), generator=g, device=card).to(dtype)
               .requires_grad_() for h in (Hq, Hkv, Hkv)]
    kw = dict(causal=causal, window=window)
    got, want, counts = _grads_both(
        lambda q, k, v: ops.flash_attention(q, k, v, **kw),
        lambda q, k, v: fa.flash_attention_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            **kw).transpose(1, 2), (q, k, v))
    assert counts["flash_attention"] == 1
    _hold(got, want, dtype, f"flash {spec}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True],
                         ids=["from-zeros", "from-state"])
def test_ssd_kernel_gradients_match_plain(card, with_state, dtype):
    """mamba2-780m's width (H 48, P 64, N 128), x, B and C strided views
    of one conv_out as the model passes them."""
    H, P, N, B, S = 48, 64, 128, 2, 512
    g = _gen(card, 3)
    conv_out = torch.randn((B, S, H * P + 2 * N), generator=g,
                           device=card).to(dtype).requires_grad_()
    dt = torch.nn.functional.softplus(torch.randn(
        (B, S, H), generator=g, device=card)).requires_grad_()
    A = (-torch.linspace(1.0, 16.0, H, device=card)).requires_grad_()
    h0 = (torch.randn((B, H, P, N), generator=g, device=card)
          .requires_grad_() if with_state else None)

    def split(conv_out, dt, A, h0):
        return (conv_out[..., :H * P].reshape(B, S, H, P), dt, A,
                conv_out[..., H * P:H * P + N], conv_out[..., H * P + N:],
                h0)

    got, want, counts = _grads_both(
        lambda *a: ops.ssd_scan(*split(*a)),
        lambda *a: ssd.ssd_scan_plain(*split(*a)), (conv_out, dt, A, h0))
    assert counts["ssd_scan"] == 1
    _hold(got, want, dtype, "ssd")


@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
def test_rglru_kernel_gradients_match_plain(card, with_h0):
    """recurrentgemma-2b's width (W 2560), float32 (the kernel's dtype):
    the backward's reversed scan launches the kernel a second time."""
    B, S, W = 2, 512, 2560
    g = _gen(card, 4)
    r = torch.sigmoid(torch.randn((B, S, W), generator=g, device=card))
    log_a = (-8.0 * 0.05 * r).requires_grad_()
    bx = torch.randn((B, S, W), generator=g, device=card).requires_grad_()
    h0 = (torch.randn((B, W), generator=g, device=card).requires_grad_()
          if with_h0 else None)
    got, want, counts = _grads_both(ops.rglru_scan, rg.rglru_scan_plain,
                                    (log_a, bx, h0))
    assert counts["rglru_scan"] == 2
    _hold(got, want, torch.float32, "rglru")


def test_no_grad_calls_launch_directly(card):
    """Without a gradient to record the wrappers launch the kernel as
    before: a plain tensor out, no autograd node."""
    q = torch.randn((1, 64, 4, 64), device=card, dtype=torch.bfloat16)
    out = ops.flash_attention(q, q, q)
    assert out.grad_fn is None
    with torch.no_grad():
        qg = q.clone().requires_grad_()
        assert ops.flash_attention(qg, qg, qg).grad_fn is None
    assert ops.flash_attention(q.clone().requires_grad_(), q,
                               q).grad_fn is not None


def _reduced(arch):
    """Kernel-sized heads at reduced depth, float32."""
    if arch == "qwen3-1.7b":
        return get_arch(arch).reduced(n_layers=4, d_model=256, n_heads=4,
                                      n_kv_heads=2, head_dim=64)
    if arch == "mamba2-780m":
        return get_arch(arch).reduced(n_layers=4, d_model=256,
                                      ssm_head_dim=64, ssm_state=128)
    return get_arch(arch).reduced(n_layers=6, d_model=256, n_heads=10,
                                  n_kv_heads=1, head_dim=256, lru_width=256,
                                  attn_window=32)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-780m",
                                  "recurrentgemma-2b"])
def test_train_step_kernels_match_plain(card, arch):
    """One loss-and-gradient evaluation and one ``make_train_step`` on a
    reduced float32 model, through the kernels and through
    ``plain_versions()``."""
    cfg = _reduced(arch)
    params = T.init_params(cfg, _gen(card, 5), device=card)
    g = _gen(card, 6)
    toks = torch.randint(0, cfg.vocab_size, (2, 96), generator=g,
                         device=card)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    grad_fn = ttrain.value_and_grad(ttrain.make_loss_fn(cfg, remat=True))
    ops.reset_launch_counts()
    (lk, _), gk = grad_fn(params, batch)
    counts = ops.launch_counts()
    with ops.plain_versions():
        (lp, _), gp = grad_fn(params, batch)
    kern = {"qwen3-1.7b": "flash_attention", "mamba2-780m": "ssd_scan",
            "recurrentgemma-2b": "rglru_scan"}[arch]
    assert counts[kern] > 0, counts
    assert abs(float(lk) - float(lp)) <= 1e-5 * abs(float(lp))
    for a, b in zip(topt.tree_leaves(gk), topt.tree_leaves(gp)):
        scale = b.abs().max().item()
        assert (a - b).abs().max().item() <= STEP_GRAD_TOL * scale
    opt = topt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    step = ttrain.make_train_step(cfg, opt, remat=True)
    sk, mk = step(ttrain.TrainState(params, topt.init_opt_state(params)),
                  batch)
    assert bool(torch.isfinite(mk["loss"])) and float(mk["grad_norm"]) > 0


def test_serving_after_training_replays_the_eager_step(card):
    """A bf16 model after two train steps through the kernels serves with
    its decode step captured once, and the streams equal the eager
    step's."""
    from test_torch_cuda import _prompts, _serve, _small
    cfg = _small("qwen3-1.7b")
    params = T.init_params(cfg, _gen(card, 7), device=card)
    opt = topt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    state = ttrain.TrainState(params, topt.init_opt_state(params))
    step = ttrain.make_train_step(cfg, opt, remat=True)
    g = _gen(card, 8)
    for _ in range(2):
        toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=g,
                             device=card)
        state, _ = step(state, {"tokens": toks,
                                "labels": torch.roll(toks, -1, 1)})
    assert not any(p.requires_grad for p in topt.tree_leaves(state.params))
    prompts = _prompts(cfg)
    cap, creqs = _serve(card, cfg, state.params, prompts)
    cap.run()
    eag, ereqs = _serve(card, cfg, state.params, prompts, eager=True)
    eag.run()
    assert [r.generated for r in creqs] == [r.generated for r in ereqs]
    assert cap.batcher.compile_stats()["decode_compiles"] == 1
