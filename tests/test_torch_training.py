"""The port's training path against the JAX package's: AdamW, the loss,
each family's loss and gradients, and whole train steps.

The reference runs as its own tests run it on the CPU: ``jax.value_and_grad``
of its loss and ``jax.jit(make_train_step(...))`` on ``.reduced()`` float32
configs, with weights drawn under ``stable_init`` and handed to the port
through ``params_from_jax``; inputs come from numpy with a seed.  On the
CPU the port's kernels run their plain versions, and autograd
differentiates them.

Tolerances:
  * one ``adamw_update`` from the same gradients: float32 leaves within
    1e-6 of each leaf's max |value| (the arithmetic is the same, only
    XLA's fusion and rounding of the float32 expression may differ); a
    bf16 parameter within one bf16 ulp of itself (a rounding of that
    float32 value);
  * loss within 1e-5 relative; every gradient leaf within 1e-4 of that
    leaf's max |g| (two float32 programs that sum in other orders);
  * whole steps: see ``test_train_steps_match_reference_jit``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.models import transformer as JT
from repro.training import optimizer as jopt
from repro.training import train as jtrain
from repro_torch.configs.base import get_arch, shared_fields
from repro_torch.convert import params_from_jax, to_numpy
from repro_torch.training import optimizer as topt
from repro_torch.training import train as ttrain
from test_torch_stable_init import stable_init

KEY = jax.random.PRNGKey(17)
GRAD_TOL = 1e-4
LOSS_RTOL = 1e-5
ADAMW_TOL = 1e-6


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _leaf_close(got, want, tol, what):
    got = np.asarray(to_numpy(got), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max() if want.size else 0.0
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= tol * scale or (scale == 0.0 and err == 0.0), \
        f"{what}: max|diff| {err} > {tol} * {scale}"


def _tree_close(got, want, tol, what=""):
    """Every leaf of the port's tree (nested dicts) against the
    reference's (numpy)."""
    if isinstance(want, dict):
        assert set(got) == set(want), (what, set(got) ^ set(want))
        for k in want:
            _tree_close(got[k], want[k], tol, f"{what}/{k}")
    else:
        _leaf_close(got, want, tol, what)


def _pair(arch, **over):
    jcfg = jget_arch(arch).reduced(**over)
    tcfg = get_arch(arch).reduced(**over)
    assert shared_fields(tcfg) == jcfg.__dict__
    with stable_init():
        jparams = JT.init_params(jcfg, KEY)
    return jcfg, jparams, tcfg


def _batch(cfg, rng, B=2, S=24):
    """numpy batch: tokens (or embeddings for the audio and vision stubs,
    with (t, h, w) positions for M-RoPE) and labels, a few ignored."""
    if cfg.family == "audio" or cfg.mrope:
        batch = {"embeds": rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                        (B, S)).astype(np.int32)}
    if cfg.mrope:
        t = np.arange(S)
        pos = np.stack([t, 2 * t + 1, 3 * t + 2], axis=-1)
        batch["positions"] = np.broadcast_to(pos, (B, S, 3)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[:, :3] = -1
    batch["labels"] = labels
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _opt_tree(rng, dtype):
    return {"norm": rng.standard_normal((6,)),
            "blocks": {"ln": rng.standard_normal((3, 6)),
                       "w": rng.standard_normal((3, 6, 5)) * 0.1},
            "head": rng.standard_normal((6, 5))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    """One update from the second step on (non-zero moments), on 1-D,
    stacked (L, D) and (L, Din, Dout) leaves: decay on every leaf of
    ndim >= 2, the stacked norm (L, D) included."""
    rng = np.random.default_rng(0)
    jdt = jnp.dtype(dtype)
    params = jax.tree.map(lambda a: jnp.asarray(a, jdt), _opt_tree(rng, 0))
    grads = jax.tree.map(lambda a: jnp.asarray(a, jdt), _opt_tree(rng, 0))
    m = jax.tree.map(lambda a: jnp.asarray(a * 0.01, jnp.float32),
                     _opt_tree(rng, 0))
    v = jax.tree.map(lambda a: jnp.asarray(np.abs(a) * 1e-3, jnp.float32),
                     _opt_tree(rng, 0))
    cfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=20,
                           grad_clip=0.5)
    jstate = jopt.OptState(jnp.asarray(4, jnp.int32), m, v)
    jp, js, jm = jopt.adamw_update(cfg, params, grads, jstate)

    tcfg = topt.AdamWConfig(**dataclasses.asdict(cfg))
    tp = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    tstate = topt.OptState(torch.tensor(4, dtype=torch.int32),
                           params_from_jax(_np(m), "cpu"),
                           params_from_jax(_np(v), "cpu"))
    gp, gs, gm = topt.adamw_update(
        tcfg, tp, params_from_jax(jax.tree.map(np.asarray, grads), "cpu"),
        tstate)
    assert int(gs.step) == int(js.step) == 5
    _tree_close(gs.m, _np(js.m), ADAMW_TOL, "m")
    _tree_close(gs.v, _np(js.v), ADAMW_TOL, "v")
    for k in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(gm[k]), float(jm[k]), rtol=1e-6)
    if dtype == "float32":
        _tree_close(gp, _np(jp), ADAMW_TOL, "params")
    else:
        for g, w in zip(topt.tree_leaves(gp), jax.tree.leaves(jp)):
            assert g.dtype == torch.bfloat16
            w = np.asarray(w, np.float32)
            ulp = np.abs(w) * 2.0 ** -7 + 1e-30
            assert np.all(np.abs(g.float().numpy() - w) <= ulp)
    # the decay rule: without decay the stacked norm (L, D) lands
    # elsewhere, the 1-D norm at the same place
    nodecay = topt.adamw_update(
        dataclasses.replace(tcfg, weight_decay=0.0),
        params_from_jax(jax.tree.map(np.asarray, params), "cpu"),
        params_from_jax(jax.tree.map(np.asarray, grads), "cpu"),
        topt.OptState(torch.tensor(4, dtype=torch.int32),
                      params_from_jax(_np(m), "cpu"),
                      params_from_jax(_np(v), "cpu")))[0]
    assert not torch.equal(nodecay["blocks"]["ln"], gp["blocks"]["ln"])
    assert torch.equal(nodecay["norm"], gp["norm"])


def test_lr_schedule_matches_reference():
    cfg = jopt.AdamWConfig(lr=3e-3, warmup_steps=7, total_steps=40,
                           min_lr_frac=0.2)
    tcfg = topt.AdamWConfig(**dataclasses.asdict(cfg))
    for step in range(0, 41):
        np.testing.assert_allclose(float(topt.lr_at(tcfg, step)),
                                   float(jopt.lr_at(cfg, step)), rtol=1e-6,
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("max_norm", [0.1, 100.0], ids=["clips", "passes"])
def test_global_norm_and_clip_match_reference(max_norm):
    rng = np.random.default_rng(1)
    tree = _opt_tree(rng, 0)
    jt = jax.tree.map(jnp.asarray, tree)
    tt = params_from_jax({k: v for k, v in tree.items()}, "cpu")
    np.testing.assert_allclose(float(topt.global_norm(tt)),
                               float(jopt.global_norm(jt)), rtol=1e-6)
    gc, gn = topt.clip_by_global_norm(tt, max_norm)
    jc, jn = jopt.clip_by_global_norm(jt, max_norm)
    np.testing.assert_allclose(float(gn), float(jn), rtol=1e-6)
    _tree_close(gc, _np(jc), 1e-6, "clipped")
    assert min(max_norm, float(jn)) == pytest.approx(
        float(topt.global_norm(gc)), rel=1e-5)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def test_cross_entropy_ignores_labels_like_reference():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    labels[0, :4] = -1
    labels[2, 6] = -1
    jl, jn = jtrain.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    tl, tn = ttrain.cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(labels))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert float(tn) == float(jn) == 21 - 5
    # every label ignored: zero loss over a count of 1
    none = np.full((3, 7), -1, np.int32)
    tl0, tn0 = ttrain.cross_entropy(torch.from_numpy(logits),
                                    torch.from_numpy(none))
    jl0, jn0 = jtrain.cross_entropy(jnp.asarray(logits), jnp.asarray(none))
    assert float(tl0) == float(jl0) == 0.0
    assert float(tn0) == float(jn0) == 1.0


@pytest.mark.parametrize("method", ["none", "bf16"])
def test_compress_grads_matches_reference(method):
    rng = np.random.default_rng(3)
    tree = _opt_tree(rng, 0)
    jt = jtrain.compress_grads(jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float32), tree), method)
    tt = ttrain.compress_grads(params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), tree), "cpu"),
        method)
    want = torch.bfloat16 if method == "bf16" else torch.float32
    for g, w in zip(topt.tree_leaves(tt), jax.tree.leaves(jt)):
        assert g.dtype == want
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
    with pytest.raises(ValueError):
        ttrain.compress_grads(tt, "int8")


# ---------------------------------------------------------------------------
# loss and gradients per family
# ---------------------------------------------------------------------------

FAMILIES = [
    ("pipeboost-opt-1.3b", {}),
    ("qwen3-1.7b", {}),                         # GQA, qk-norm
    ("mamba2-780m", {}),                        # SSD scan
    ("recurrentgemma-2b", {}),                  # RG-LRU, window
    ("qwen2-moe-a2.7b", {}),                    # aux loss, default capacity
    ("qwen2-moe-a2.7b", {"capacity_factor": 0.5}),   # tokens dropped
    ("hubert-xlarge", {}),                      # non-causal, LayerNorm
    ("qwen2-vl-72b", {}),                       # M-RoPE from embeddings
]


@pytest.mark.parametrize("arch,over", FAMILIES,
                         ids=[a + ("-cf0.5" if o else "")
                              for a, o in FAMILIES])
def test_loss_and_grads_match_reference(arch, over):
    jcfg, jparams, tcfg = _pair(arch, **over)
    batch = _batch(tcfg, np.random.default_rng(4))
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        jtrain.make_loss_fn(jcfg, remat=False), has_aux=True))(jparams,
                                                               _j(batch))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    (tloss, tm), tgrads = ttrain.value_and_grad(
        ttrain.make_loss_fn(tcfg, remat=False))(tparams, _t(batch))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    for k in ("ce", "aux", "tokens"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    if tcfg.family == "moe":
        assert float(tm["aux"]) > 0
    for g in topt.tree_leaves(tgrads):
        assert bool(torch.isfinite(g).all())
    jgrads = _np(jgrads)
    if tcfg.family == "ssm":
        jgrads = _finite_part(jgrads, tgrads)
    _tree_close(tgrads, jgrads, GRAD_TOL, arch)
    nonzero = [g for g in topt.tree_leaves(tgrads) if g.abs().max() > 0]
    assert len(nonzero) >= len(topt.tree_leaves(tgrads)) - 1


def _finite_part(jgrads, tgrads):
    """The reference's SSD gradient is NaN in part of every SSM layer: its
    ``ssd_chunked`` takes exp of the segment sums above the causal
    diagonal, where they are positive and overflow, and masks after the
    exp (``jnp.where(causal, jnp.exp(seg), 0.0)``), so the backward meets
    0 * inf.  The loss is finite, so the forward agrees; the port masks
    before the exp and its gradient is finite everywhere (checked above).
    Where the reference's gradient is NaN, its entries are replaced by the
    port's, so the comparison covers every entry the reference has (none
    of the SSM blocks' input norm, about half of each other SSM leaf, all
    but a few rows of the embedding)."""
    def fill(j, t):
        return np.where(np.isfinite(j), j,
                        np.asarray(to_numpy(t), np.float32))
    return {k: _finite_part(v, tgrads[k]) if isinstance(v, dict)
            else fill(v, tgrads[k]) for k, v in jgrads.items()}


# ---------------------------------------------------------------------------
# whole train steps against the reference's jitted step
# ---------------------------------------------------------------------------

def _port_state(jstate):
    p = params_from_jax(jax.tree.map(np.asarray, jstate.params), "cpu")
    return ttrain.TrainState(p, topt.OptState(
        torch.tensor(int(jstate.opt.step), dtype=torch.int32),
        params_from_jax(_np(jstate.opt.m), "cpu"),
        params_from_jax(_np(jstate.opt.v), "cpu")))


@pytest.mark.parametrize("remat,accum", [(False, 1), (True, 1), (True, 2)],
                         ids=["plain", "remat", "remat-accum2"])
def test_train_steps_match_reference_jit(remat, accum):
    """One and three steps of ``make_train_step`` against the reference's
    jitted step from the same state and batches: metrics, params, m and v.

    The tolerance of the parameters: AdamW's first steps divide m by
    sqrt(v) + eps, about g / (|g| + eps), so a gradient entry whose size
    is near the two programs' sum-order difference (about 1e-7 of its
    leaf's max |g|) may move its parameter by up to lr in either
    direction.  Each parameter is therefore held within 2·lr per step
    taken, and all but 1e-3 of each leaf's entries within 1e-5 of the
    leaf's max |p|; m and v (which carry no such division) within 1e-4 of
    their leaf's max."""
    jcfg, jparams, tcfg = _pair("qwen3-1.7b")
    opt = jopt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    topt_cfg = topt.AdamWConfig(**dataclasses.asdict(opt))
    jstep = jax.jit(jtrain.make_train_step(jcfg, opt, remat=remat,
                                           accum=accum))
    tstep = ttrain.make_train_step(tcfg, topt_cfg, remat=remat, accum=accum)
    jstate = jtrain.TrainState(jparams, jopt.init_opt_state(jparams))
    tstate = _port_state(jstate)
    rng = np.random.default_rng(5)
    lr_sum = 0.0
    for n in range(1, 4):
        batch = _batch(tcfg, rng, B=4, S=16)
        jstate, jm = jstep(jstate, _j(batch))
        tstate, tm = tstep(tstate, _t(batch))
        lr_sum += float(jm["lr"])
        for k in ("loss", "ce", "aux", "tokens", "lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {n} {k}")
        if n not in (1, 3):
            continue
        assert int(tstate.opt.step) == int(jstate.opt.step) == n
        _tree_close(tstate.opt.m, _np(jstate.opt.m), 1e-4, f"step {n} m")
        _tree_close(tstate.opt.v, _np(jstate.opt.v), 1e-4, f"step {n} v")
        for g, w in zip(topt.tree_leaves(tstate.params),
                        jax.tree.leaves(_np(jstate.params))):
            d = np.abs(g.numpy().astype(np.float64) - w)
            assert d.max() <= 2 * lr_sum, (n, d.max(), lr_sum)
            assert np.mean(d > 1e-5 * np.abs(w).max()) <= 1e-3, \
                (n, np.mean(d > 1e-5 * np.abs(w).max()))


def test_remat_equals_no_remat():
    """The same step with every layer rematerialised: the recompute runs
    the same float32 operations, so the results are equal."""
    _, jparams, tcfg = _pair("recurrentgemma-2b")
    opt = topt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = _t(_batch(tcfg, np.random.default_rng(6)))
    out = []
    for remat in (False, True):
        state = _port_state(jtrain.TrainState(jparams,
                                              jopt.init_opt_state(jparams)))
        state, m = ttrain.make_train_step(tcfg, opt, remat=remat)(state,
                                                                  batch)
        out.append((state, m))
    (s0, m0), (s1, m1) = out
    assert float(m0["loss"]) == float(m1["loss"])
    for a, b in zip(topt.tree_leaves(s0), topt.tree_leaves(s1)):
        assert torch.equal(a, b)


def test_eval_step_matches_reference_loss():
    jcfg, jparams, tcfg = _pair("pipeboost-opt-1.3b")
    batch = _batch(tcfg, np.random.default_rng(7))
    jm = jtrain.make_eval_step(jcfg)(jparams, _j(batch))
    tm = ttrain.make_eval_step(tcfg)(
        params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"),
        _t(batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    assert not tm["loss"].requires_grad
