"""The port's layers and dense/GQA model against the JAX package.

The reference initialises the weights (a ``jax.random`` key); the port
takes the same weights through ``convert.params_from_jax``.  Inputs are
made with numpy from a seed.  Tolerances: 2e-5 on float32 layer outputs
(the reference's kernel tolerance) and 1e-4 absolute on float32 logits and
caches after a prefill and six decode steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as JT
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_jax, to_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as TT

LAYER_TOL = 2e-5
LOGIT_TOL = 1e-4


def _rnd(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(to_numpy(a), np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=0)


def test_configs_are_own_copies_of_the_reference():
    from repro.configs.base import ARCH_IDS as J_IDS
    from repro_torch.configs.base import ARCH_IDS
    assert ARCH_IDS == J_IDS
    for name in ARCH_IDS:
        a, b = get_arch(name), jget_arch(name)
        assert a.__dict__ == b.__dict__
        assert a.padded_vocab == b.padded_vocab
        assert a.param_count() == b.param_count()
        assert a.reduced().__dict__ == b.reduced().__dict__


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_layers_match(act):
    rng = np.random.default_rng(0)
    x = _rnd(rng, (2, 5, 3, 32))
    w = _rnd(rng, (32,)) + 1.0
    _close(tlayers.rms_norm(torch.from_numpy(w), torch.from_numpy(x)),
           jlayers.rms_norm(jnp.asarray(w), jnp.asarray(x)), LAYER_TOL)
    ln = {"scale": w, "bias": _rnd(rng, (32,))}
    _close(tlayers.layer_norm({k: torch.from_numpy(v) for k, v in ln.items()},
                              torch.from_numpy(x)),
           jlayers.layer_norm({k: jnp.asarray(v) for k, v in ln.items()},
                              jnp.asarray(x)), LAYER_TOL)
    pos = rng.integers(0, 200, size=(2, 5)).astype(np.int32)
    _close(tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              1e4),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4),
           LAYER_TOL)
    p = {"w_gate": _rnd(rng, (32, 48), 0.2), "w_up": _rnd(rng, (32, 48), 0.2),
         "w_down": _rnd(rng, (48, 32), 0.2)}
    _close(tlayers.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), act),
           jlayers.mlp({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x), act), LAYER_TOL)


@pytest.mark.parametrize("window,slot_mask", [(0, False), (24, False),
                                              (0, True)])
def test_attention_partials_match(window, slot_mask):
    """attention_partial / merge_partials / finalize_partial and the
    zero-copy merged decode against the reference's XLA path."""
    rng = np.random.default_rng(1)
    B, S, Hq, Hkv, d = 2, 70, 4, 2, 16
    q, k, v = (_rnd(rng, (B, S, H, d)) for H in (Hq, Hkv, Hkv))
    lens = np.array([0, 50], np.int32)
    sm = rng.random((B, S)) > 0.25 if slot_mask else None
    kw = dict(causal=True, window=window, block_k=32,
              kv_valid_len=lens)
    pj = jattn.attention_partial(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), **kw,
                                 kv_slot_mask=None if sm is None
                                 else jnp.asarray(sm))
    pt = tattn.attention_partial(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), **kw,
                                 kv_slot_mask=None if sm is None
                                 else torch.from_numpy(sm))
    for a, b in zip(pt, pj):
        _close(a, b, LAYER_TOL)
    half = S // 2
    parts_j = [jattn.attention_partial(jnp.asarray(q), jnp.asarray(k[:, s]),
                                       jnp.asarray(v[:, s]), causal=False)
               for s in (slice(0, half), slice(half, S))]
    parts_t = [tattn.attention_partial(torch.from_numpy(q),
                                       torch.from_numpy(k[:, s]),
                                       torch.from_numpy(v[:, s]),
                                       causal=False)
               for s in (slice(0, half), slice(half, S))]
    _close(tattn.finalize_partial(tattn.merge_partials(*parts_t),
                                  torch.float32),
           jattn.finalize_partial(jattn.merge_partials(*parts_j),
                                  jnp.float32), LAYER_TOL)
    qd, kn, vn = _rnd(rng, (B, 1, Hq, d)), _rnd(rng, (B, 1, Hkv, d)), \
        _rnd(rng, (B, 1, Hkv, d))
    _close(tattn.decode_attention_merged(
               torch.from_numpy(qd), torch.from_numpy(k), torch.from_numpy(v),
               torch.from_numpy(lens), torch.from_numpy(kn),
               torch.from_numpy(vn),
               kv_slot_mask=None if sm is None else torch.from_numpy(sm)),
           jattn.decode_attention_merged(
               jnp.asarray(qd), jnp.asarray(k), jnp.asarray(v),
               jnp.asarray(lens), jnp.asarray(kn), jnp.asarray(vn),
               kv_slot_mask=None if sm is None else jnp.asarray(sm)),
           LAYER_TOL)


def _nonzero_qkv_biases(jparams):
    """The reference initialises the QKV biases to zeros, which would leave
    the bias path untested: draw them from N(0, 0.5^2) instead."""
    rng = np.random.default_rng(5)
    attn = dict(jparams["blocks"]["attn"])
    for name in ("bq", "bk", "bv"):
        attn[name] = jnp.asarray(_rnd(rng, attn[name].shape, 0.5))
    return {**jparams, "blocks": {**jparams["blocks"], "attn": attn}}


# case -> (reduced config, prompt length, max_len, edit of the weights)
CASES = {
    "opt": (lambda: jget_arch("pipeboost-opt-1.3b").reduced(), 21, 48, None),
    "qwen3": (lambda: jget_arch("qwen3-1.7b").reduced(), 21, 48, None),
    "qwen3-ring": (lambda: jget_arch("qwen3-1.7b").reduced(attn_window=32),
                   40, 64, None),
    "qwen2.5-qkv-bias": (lambda: jget_arch("qwen2.5-14b").reduced(), 21, 48,
                         _nonzero_qkv_biases),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_decode_match(case):
    """Prefill (padded rows with ``last_index`` where the cache is full
    length; a prompt longer than the window for the ring) plus six
    teacher-forced zero-copy decode steps: logits and caches.  The
    qwen2.5 case holds the QKV-bias path, with its biases made non-zero."""
    make_cfg, S, max_len, edit = CASES[case]
    jcfg = make_cfg()
    tcfg = get_arch(jcfg.name).reduced(
        **{f: getattr(jcfg, f) for f in ("attn_window",)})
    assert tcfg.__dict__ == jcfg.__dict__
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(3))
    if edit is not None:
        jparams = edit(jparams)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(7)
    B = 2
    toks = rng.integers(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    last = None
    if jcfg.attn_window == 0:
        last = np.array([S - 1, S - 6], np.int32)   # row 1 right-padded
    jfwd = jax.jit(lambda p, t: JT.forward(jcfg, p, {"tokens": t},
                                           mode="prefill", max_len=max_len,
                                           last_index=last))
    jdec = jax.jit(lambda p, t, c: JT.decode_step(jcfg, p, {"tokens": t}, c))
    lj, cj = jfwd(jparams, jnp.asarray(toks))
    lt, ct = TT.forward(tcfg, tparams, {"tokens": torch.from_numpy(toks)},
                        mode="prefill", max_len=max_len, last_index=last)
    assert lt.shape == lj.shape == (B, jcfg.padded_vocab)
    assert lt.dtype == torch.float32
    _close(lt, lj, LOGIT_TOL)
    np.testing.assert_array_equal(to_numpy(ct["pos"]), np.asarray(cj["pos"]))
    for leaf in ("k", "v"):
        _close(ct["attn"][leaf], cj["attn"][leaf], LOGIT_TOL)
    for _ in range(6):
        step = rng.integers(0, jcfg.vocab_size, size=(B,)).astype(np.int32)
        lj, cj = jdec(jparams, jnp.asarray(step), cj)
        lt, ct = TT.decode_step(tcfg, tparams,
                                {"tokens": torch.from_numpy(step)}, ct)
        _close(lt, lj, LOGIT_TOL)
    np.testing.assert_array_equal(to_numpy(ct["pos"]), np.asarray(cj["pos"]))
    for leaf in ("k", "v"):
        _close(ct["attn"][leaf], cj["attn"][leaf], LOGIT_TOL)


def test_train_forward_matches():
    jcfg = jget_arch("qwen3-1.7b").reduced()
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(4))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.random.default_rng(8).integers(0, 257, size=(2, 12))
    lj, _ = JT.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    lt, _ = TT.forward(get_arch("qwen3-1.7b").reduced(), tparams,
                       {"tokens": torch.from_numpy(toks)})
    _close(lt, lj, LOGIT_TOL)


def test_init_params_layout_matches_reference():
    """The port's own init has the reference's tree, shapes and dtypes."""
    for name in ("pipeboost-opt-1.3b", "qwen3-1.7b", "qwen2.5-14b",
                 "mamba2-780m", "recurrentgemma-2b"):
        jcfg = jget_arch(name).reduced()
        jp = jax.tree.map(np.asarray, JT.init_params(jcfg,
                                                     jax.random.PRNGKey(0)))
        tp = TT.init_params(get_arch(name).reduced(),
                            torch.Generator().manual_seed(0), device="cpu")
        flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
        flat_t = jax.tree_util.tree_flatten_with_path(to_numpy(tp))[0]
        assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
        for (_, a), (_, b) in zip(flat_j, flat_t):
            assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "qwen2-vl-72b",
                                  "hubert-xlarge"])
def test_unported_families_raise(name):
    with pytest.raises(NotImplementedError):
        TT.init_params(get_arch(name).reduced(),
                       torch.Generator().manual_seed(0), device="cpu")
