"""The decode step's fused RMSNorm and RoPE ops (``kernels/rms_norm.py``,
``kernels/rope.py``, ``ops.rms_norm``, ``ops.rope_qk``), on the CPU.

Checked here: each plain version equals the composition the model ran
before (``models/layers.py``'s ``rms_norm`` after a rounded add, its
``apply_rope``) bit for bit in bf16 and float32; the wrappers' checks
refuse what the kernels do not take, and the ops refuse DTensors; which
calls one ``decode_step`` makes of each op, family by family (under
``ops.traced``); and that ``decode_step``'s logits and cache equal, bit
for bit, those of the layer loop written with the plain composition, for
every family with a decode step and for granite-4.0-h-small at tiny widths
(its SSM layers' state update written out as the lines ``ops.ssm_step``'s
plain version took over, which updates the state in place).  The kernels
themselves run on the card (``tests/test_torch_cuda.py``).
"""
import collections
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs.base import get_arch
from repro_torch.kernels import ops
from repro_torch.kernels import rms_norm as rn
from repro_torch.kernels import rope as rp
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers
from repro_torch.models import mamba2
from repro_torch.models import transformer as T

DTYPES = [torch.bfloat16, torch.float32]


def _randn(shape, dtype, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(dtype)


# ---------------------------------------------------------------------------
# plain versions against the composition they replace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,D,eps", [(32, 2048, 1e-5), (4, 2560, 1e-6),
                                     (3, 64, 1e-6)])
def test_rms_norm_plain_is_the_composition(dtype, B, D, eps):
    x = _randn((B, 1, D), dtype, 0, 3.0)
    res = _randn((B, 1, D), dtype, 1)
    w = _randn((D,), dtype, 2, 0.5) + 1
    h = rn.rms_norm_plain(x, w, eps)
    assert h.dtype == dtype and torch.equal(h, layers.rms_norm(w, x, eps))
    s, h2 = rn.rms_norm_plain(x, w, eps, residual=res)
    assert torch.equal(s, res + x)
    assert torch.equal(h2, layers.rms_norm(w, res + x, eps))
    # the op on CPU tensors is the plain version, and launches nothing
    ops.reset_launch_counts()
    assert torch.equal(ops.rms_norm(x, w, eps), h)
    s3, h3 = ops.rms_norm(x, w, eps, residual=res)
    assert torch.equal(s3, s) and torch.equal(h3, h2)
    assert ops.launch_counts()["rms_norm"] == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Hq,Hkv,hd,theta", [
    (32, 32, 32, 64, 1e4),            # pipeboost-opt-1.3b
    (64, 16, 16, 128, 1e6),           # qwen2-moe-a2.7b
    (4, 10, 1, 256, 1e4),             # recurrentgemma-2b
    (3, 4, 2, 16, 1e4),
])
def test_rope_qk_plain_is_apply_rope(dtype, B, Hq, Hkv, hd, theta):
    q = _randn((B, 1, Hq, hd), dtype, 3)
    k = _randn((B, 1, Hkv, hd), dtype, 4)
    g = torch.Generator().manual_seed(5)
    pos = torch.randint(0, 2304, (B,), generator=g, dtype=torch.int32)
    pos[0] = 0
    inv = layers.kept_rope_freqs(hd, theta, "cpu")
    assert torch.equal(inv, layers.rope_freqs(hd, theta, "cpu"))
    qo, ko = rp.rope_qk_plain(q, k, pos, inv)
    assert torch.equal(qo, layers.apply_rope(q, pos[:, None], theta))
    assert torch.equal(ko, layers.apply_rope(k, pos[:, None], theta))
    ops.reset_launch_counts()
    qo2, ko2 = ops.rope_qk(q, k, pos, inv)
    assert torch.equal(qo2, qo) and torch.equal(ko2, ko)
    assert ops.launch_counts()["rope"] == 0


def test_rope_freqs_are_made_once():
    a = layers.kept_rope_freqs(64, 1e4, torch.device("cpu"))
    assert layers.kept_rope_freqs(64, 1e4, "cpu") is a
    assert layers.kept_rope_freqs(64, 1e6, "cpu") is not a
    assert layers.kept_rope_freqs(128, 1e4, "cpu").shape == (64,)


# ---------------------------------------------------------------------------
# what the wrappers refuse
# ---------------------------------------------------------------------------

def _norm_case(what):
    bf = torch.bfloat16
    x = torch.zeros((4, 1, 64), dtype=bf)
    w = torch.ones((64,), dtype=bf)
    res = None
    if what == "float16":
        x, w = x.half(), w.half()
    elif what == "mixed dtypes":
        w = w.float()
    elif what == "w shape":
        w = torch.ones((32,), dtype=bf)
    elif what == "D not a multiple of 8":
        x, w = torch.zeros((4, 1, 60), dtype=bf), torch.ones((60,), dtype=bf)
    elif what == "D too wide":
        x = torch.zeros((1, 1, 16392), dtype=bf)
        w = torch.ones((16392,), dtype=bf)
    elif what == "strided x":
        x = torch.zeros((4, 1, 128), dtype=bf)[..., ::2]
    elif what == "transposed x":
        x = torch.zeros((64, 4), dtype=bf).T
    elif what == "misaligned x":
        x = torch.zeros((4 * 64 + 1,), dtype=bf)[1:].view(4, 1, 64)
    elif what == "residual shape":
        res = torch.zeros((4, 1, 32), dtype=bf)
    elif what == "residual dtype":
        res = torch.zeros((4, 1, 64))
    elif what == "strided residual":
        res = torch.zeros((4, 2, 64), dtype=bf)[:, :1]
    return x, w, res


@pytest.mark.parametrize("what", [
    "float16", "mixed dtypes", "w shape", "D not a multiple of 8",
    "D too wide", "strided x", "transposed x", "misaligned x",
    "residual shape", "residual dtype", "strided residual"])
def test_rms_norm_kernel_refuses(what):
    x, w, res = _norm_case(what)
    with pytest.raises(ValueError, match="rms_norm kernel"):
        rn.check_args(x, w, res)


def test_rms_norm_kernel_takes_the_decode_rows():
    for dtype in DTYPES:
        x = torch.zeros((32, 1, 2048), dtype=dtype)
        rn.check_args(x, torch.ones((2048,), dtype=dtype), x.clone())


def _rope_case(what):
    bf = torch.bfloat16
    q = torch.zeros((4, 1, 8, 64), dtype=bf)
    k = torch.zeros((4, 1, 2, 64), dtype=bf)
    pos = torch.zeros((4,), dtype=torch.int32)
    inv = layers.rope_freqs(64, 1e4)
    if what == "float16":
        q, k = q.half(), k.half()
    elif what == "mixed dtypes":
        k = k.float()
    elif what == "two tokens":
        q = torch.zeros((4, 2, 8, 64), dtype=bf)
    elif what == "head dims differ":
        k = torch.zeros((4, 1, 2, 32), dtype=bf)
    elif what == "odd head dim":
        q = torch.zeros((4, 1, 8, 63), dtype=bf)
        k = torch.zeros((4, 1, 2, 63), dtype=bf)
    elif what == "strided head dim":
        q = torch.zeros((4, 1, 8, 128), dtype=bf)[..., ::2]
    elif what == "int64 positions":
        pos = pos.long()
    elif what == "positions shape":
        pos = pos[:, None]
    elif what == "bf16 inv_freq":
        inv = inv.to(bf)
    elif what == "inv_freq shape":
        inv = layers.rope_freqs(128, 1e4)
    return q, k, pos, inv


@pytest.mark.parametrize("what", [
    "float16", "mixed dtypes", "two tokens", "head dims differ",
    "odd head dim", "strided head dim", "int64 positions",
    "positions shape", "bf16 inv_freq", "inv_freq shape"])
def test_rope_kernel_refuses(what):
    with pytest.raises(ValueError, match="rope kernel"):
        rp.check_args(*_rope_case(what))


def test_rope_kernel_takes_strided_heads():
    """q and k as views of one fused projection (rows and heads strided,
    the head dim contiguous) are taken as they are."""
    qkv = torch.zeros((4, 1, 12, 64), dtype=torch.bfloat16)
    rp.check_args(qkv[:, :, :8], qkv[:, :, 8:10], torch.zeros(
        (4,), dtype=torch.int32), layers.rope_freqs(64, 1e4))


def test_fused_ops_refuse_dtensors():
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.launch.dryrun import fake_mesh
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh(("data",), (2,), (torch.device("cpu"),) * 2)
    with fake_mesh(mesh) as dmesh:
        def dt(t):
            return distribute_tensor(t, dmesh, [Replicate()],
                                     src_data_rank=None)
        x = dt(torch.zeros((4, 1, 64)))
        w = dt(torch.ones((64,)))
        with pytest.raises(TypeError, match="DTensor"):
            ops.rms_norm(x, w, 1e-6)
        with pytest.raises(TypeError, match="DTensor"):
            ops.rms_norm(torch.zeros((4, 1, 64)), torch.ones((64,)), 1e-6,
                         residual=x)
        q = dt(torch.zeros((4, 1, 4, 16)))
        with pytest.raises(TypeError, match="DTensor"):
            ops.rope_qk(q, q, torch.zeros((4,), dtype=torch.int32),
                        layers.rope_freqs(16, 1e4))


# ---------------------------------------------------------------------------
# which calls a decode step makes
# ---------------------------------------------------------------------------

def _cfg(arch, dtype="float32"):
    if arch == "granite-4.0-h-small":
        # one 10-layer period (attention at layer 5) at tiny widths, as
        # tests/test_torch_granite.py runs it (``reduced`` would give the
        # hybrid family a window)
        return dataclasses.replace(
            get_arch(arch), n_layers=10, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=24, moe_d_ff=24, shared_d_ff=40,
            n_experts=8, top_k=3, n_shared_experts=1, vocab_size=257,
            ssm_state=16, ssm_head_dim=16, ssm_chunk=16, dtype=dtype)
    return get_arch(arch).reduced(n_layers=3, dtype=dtype) \
        if arch == "recurrentgemma-2b" else \
        get_arch(arch).reduced(n_layers=4, dtype=dtype)


def _inputs(cfg, B, seed=0):
    """(params, prefill batch, decode batches of 3 steps)."""
    g = torch.Generator().manual_seed(seed)
    params = T.init_params(cfg, g, device="cpu")
    S = 40      # past recurrentgemma's reduced window of 32: the ring wraps
    if cfg.family == "vlm":
        def pos3(p):                  # t, h and w all different
            return torch.stack([p, p // 2, p // 3], -1).to(torch.int32)
        base = torch.arange(S)[None].expand(B, S)
        pre = {"embeds": torch.randn((B, S, cfg.d_model), generator=g)
               .to(T.torch_dtype(cfg)), "positions": pos3(base)}
        steps = [{"embeds": torch.randn((B, 1, cfg.d_model), generator=g)
                  .to(T.torch_dtype(cfg)),
                  "positions": pos3(torch.full((B, 1), S + i))}
                 for i in range(3)]
        return params, pre, steps
    pre = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g)}
    steps = [{"tokens": torch.randint(0, cfg.vocab_size, (B,), generator=g)}
             for _ in range(3)]
    return params, pre, steps


def _counting(calls):
    def tracer(name, args, kwargs):
        calls[name] += 1
        with ops.traced(None):
            return getattr(ops, name)(*args, **kwargs)
    return tracer


@pytest.mark.parametrize("arch", ["pipeboost-opt-1.3b", "qwen3-1.7b",
                                  "qwen2-moe-a2.7b", "recurrentgemma-2b",
                                  "mamba2-780m", "qwen2-vl-72b"])
def test_decode_step_calls_the_fused_ops(arch):
    """An attention (or MoE) layer calls ``rms_norm`` twice and
    ``rope_qk`` once, the final norm ``rms_norm`` once; recurrent and SSM
    layers, qwen3's per-head norms and M-RoPE call neither; a model
    without attention layers (mamba2) calls neither at all, and prefill
    calls neither."""
    cfg = _cfg(arch)
    params, pre, steps = _inputs(cfg, 2)
    counts = T.kind_counts(cfg)
    n_attn = counts.get("attn", 0) + counts.get("moe", 0)
    calls = collections.Counter()
    with ops.traced(_counting(calls)):
        _, cache = T.forward(cfg, params, pre, mode="prefill", max_len=64)
        assert calls["rms_norm"] == calls["rope_qk"] == 0
        T.decode_step(cfg, params, steps[0], cache)
    want = {"rms_norm": 2 * n_attn + 1 if n_attn else 0,
            "rope_qk": 0 if cfg.mrope else n_attn,
            "decode_attention": n_attn}
    assert {k: calls[k] for k in want} == want


def test_opt_decode_step_at_its_depth_and_slots():
    """pipeboost-opt-1.3b's own depth (24 layers) and 32 slots, narrow:
    2L+1 ``rms_norm`` calls and L ``rope_qk`` a step, nothing else fused
    away (L decode attentions)."""
    cfg = get_arch("pipeboost-opt-1.3b").reduced(n_layers=24)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    cache = T.init_cache(cfg, 32, 16, device="cpu")
    cache["pos"] = torch.arange(32, dtype=torch.int32) % 16
    calls = collections.Counter()
    with ops.traced(_counting(calls)):
        T.decode_step(cfg, params, {"tokens": torch.arange(32)}, cache)
    assert dict(calls) == {"rms_norm": 49, "rope_qk": 24,
                           "decode_attention": 24}


# ---------------------------------------------------------------------------
# the decode step against the plain composition
# ---------------------------------------------------------------------------

def _plain_attn_step(cfg, p, x, positions, k_cache, v_cache, cache_len):
    """The attention layer's decode step in the plain composition."""
    h = T.apply_norm(cfg, p["ln1"], x)
    q, k, v = T._project_qkv(cfg, p, h)
    q = T.rope(cfg, q, positions)
    k = T.rope(cfg, k, positions)
    C = k_cache.shape[1]
    valid_old = torch.clamp(cache_len, max=C)
    slot_mask = None
    if cfg.attn_window > 0:
        j = torch.arange(C, device=x.device)[None, :]
        p_len = cache_len[:, None]
        slot_mask = (j < p_len) & ((p_len < C) | (j != p_len % C))
    o = attn_lib.decode_attention_merged(q, k_cache, v_cache, valid_old,
                                         k, v, kv_slot_mask=slot_mask,
                                         scale=T.attn_scale(cfg))
    x, _ = T.attn_out_ffn(cfg, p, x, o, dropless=True)
    return x, k[:, 0], v[:, 0]


def _plain_ssm_step(cfg, p, x, conv_state, ssm_state):
    """The SSM layer's decode step in the plain composition: the Mamba-2
    state update as ``mixer_step`` wrote it before ``ops.ssm_step``, a new
    state returned, then the FFN where the layer has one."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    h = layers.rms_norm(p["norm"], x[:, 0], cfg.norm_eps)
    zxbcdt = h @ p["in_proj"]
    z, _, _, _, dt = mamba2._split_in_proj(cfg, zxbcdt)
    conv_out, conv_new = layers.causal_conv1d_step(
        p["conv_w"], mamba2._conv_in(cfg, zxbcdt), conv_state,
        p.get("conv_b"))
    conv_out = F.silu(conv_out)
    xs = conv_out[..., :di].reshape(-1, H, P)
    B = conv_out[..., di:di + N].float()
    C = conv_out[..., di + N:].float()
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)
    dBx = torch.einsum("bh,bn,bhp->bhpn", dt, B, xs.float())
    new_state = ssm_state * dA[..., None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", C, new_state).to(h.dtype)
    y = y + p["D_skip"].to(y.dtype)[:, None] * xs
    y = layers.rms_norm(p["gate_norm"], y.reshape(-1, di) * F.silu(z),
                        cfg.norm_eps)
    x = (x[:, 0] + layers.residual_scaled(cfg, y @ p["out_proj"]))[:, None]
    if "mlp" in p:
        f, _ = T._ffn(cfg, p["mlp"], T.apply_norm(cfg, p["ln2"], x),
                      dropless=True)
        x = x + layers.residual_scaled(cfg, f)
    return x, conv_new, new_state


def _plain_decode_step(cfg, params, batch, cache):
    """``decode_step`` with every norm and RoPE in the plain composition."""
    if "embeds" in batch:
        x = batch["embeds"]
    else:
        x = T._embed_scaled(cfg, params["embed"][
            batch["tokens"].reshape(-1)][:, None, :])
    B = x.shape[0]
    pos = cache["pos"].to(torch.int32).contiguous()
    positions = batch["positions"] if "positions" in batch else pos[:, None]
    k_rows, v_rows = [], []
    for kind, i, a in T.layers(cfg):
        p = T.layer_params(params["blocks"][kind], i)
        if a >= 0:
            x, kn, vn = _plain_attn_step(cfg, p, x, positions,
                                         cache["attn"]["k"][a],
                                         cache["attn"]["v"][a], pos)
            k_rows.append(kn)
            v_rows.append(vn)
        elif kind == "ssm":
            conv, state = cache["ssm"]["conv"][i], cache["ssm"]["state"][i]
            x, conv_new, state_new = _plain_ssm_step(cfg, p, x, conv, state)
            conv.copy_(conv_new)
            state.copy_(state_new)
        else:
            conv, h = cache["rec"]["conv"][i], cache["rec"]["h"][i]
            x, conv_new, h_new = T.rec_layer_step(cfg, p, x, conv, h)
            conv.copy_(conv_new)
            h.copy_(h_new)
    if k_rows:
        kc, vc = cache["attn"]["k"], cache["attn"]["v"]
        slot = (pos % kc.shape[2]).long()
        bidx = torch.arange(B)
        kc[:, bidx, slot] = torch.stack(k_rows)
        vc[:, bidx, slot] = torch.stack(v_rows)
    x = T.apply_norm(cfg, params["final_norm"], x)
    logits = T.unembed(cfg, params, x)[:, 0, :]
    pos.add_(1)
    return logits, cache


def _clone(cache):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in cache.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["pipeboost-opt-1.3b", "qwen3-1.7b",
                                  "qwen2-moe-a2.7b", "recurrentgemma-2b",
                                  "mamba2-780m", "granite-4.0-h-small",
                                  "qwen2-vl-72b"])
def test_decode_step_equals_the_plain_composition(arch, dtype):
    """Three steps from one prefill: logits and every cache leaf bit for
    bit (recurrentgemma's ring of 32 wraps under its 40-token prompts;
    the SSM states updated in place, where the plain composition makes a
    new state and copies it)."""
    cfg = dataclasses.replace(_cfg(arch), dtype=dtype)
    params, pre, steps = _inputs(cfg, 3, seed=1)
    _, cache = T.forward(cfg, params, pre, mode="prefill", max_len=64)
    ref = _clone(cache)
    for batch in steps:
        got, cache = T.decode_step(cfg, params, batch, cache)
        want, ref = _plain_decode_step(cfg, params, batch, ref)
        assert torch.equal(got, want)
    for kind in ("attn", "ssm", "rec"):
        for leaf, t in cache.get(kind, {}).items():
            assert torch.equal(t, ref[kind][leaf]), (kind, leaf)
    assert torch.equal(cache["pos"], ref["pos"])


def test_costs_count_each_byte_once():
    """The bounds chip_smoke times the kernels beside: every operand read
    once and every output written once (opt-1.3b's decode rows, bf16)."""
    rows, D = 32, 2048
    assert rn.cost(rows=rows, dim=D)[1] == (2 * rows * D + D) * 2
    assert rn.cost(rows=rows, dim=D, residual=True)[1] == \
        (4 * rows * D + D) * 2
    n = 32 * (32 + 32) * 64
    assert rp.cost(batch=32, heads=32, kv_heads=32, head_dim=64)[1] == \
        2 * n * 2 + 4 * 32 + 4 * 32
    assert rn.cost(rows=rows, dim=D, dtype="float32")[1] == \
        (2 * rows * D + D) * 4
