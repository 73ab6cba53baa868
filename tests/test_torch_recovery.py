"""The port's KV/state reconstruction (``core/kv_reconstruct.py``) against
the reference's (paper §4.4.2).

Reduced configs in float32, weights from the reference converted with
``params_from_jax``, token sequences from numpy.  The lost layers' state
is wiped in both packages' copies of one fresh prefill cache; each package
rebuilds it.  The port's rebuilt cache must be within 1e-4 of the
reference's rebuilt cache and within the reference's own 2e-3 of a fresh
prefill, and the work stats equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs.base import get_arch as jget_arch
from repro.core import kv_reconstruct as jrec
from repro.models import transformer as JT
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_jax, to_numpy
from repro_torch.core import kv_reconstruct as trec
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import transformer as TT
from test_torch_stable_init import stable_init

LOGIT_TOL = 1e-4          # port against reference
FRESH_TOL = 2e-3          # rebuilt against a fresh prefill (the reference's)
KEY = jax.random.PRNGKey(21)


@functools.lru_cache(maxsize=None)
def _setup(arch, layers, window=None):
    kw = {} if window is None else {"attn_window": window}
    jcfg = jget_arch(arch).reduced(n_layers=layers, **kw)
    tcfg = get_arch(arch).reduced(n_layers=layers, **kw)
    with stable_init():
        jparams = JT.init_params(jcfg, KEY)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _np_cache(jcache):
    return jax.tree.map(lambda a: np.array(a), jcache)


def _wipe(cfg, np_cache, missing):
    """Zero the state of the global layers in ``missing``."""
    out = jax.tree.map(np.copy, np_cache)
    for gi, (kind, ki, ai) in enumerate(TT.layers(cfg)):
        if gi in missing:
            key = "attn" if ai >= 0 else kind    # moe fills "attn"
            for leaf in out[key]:
                out[key][leaf][ai if ai >= 0 else ki] = 0
    return out


def _close(t, j, tol):
    np.testing.assert_allclose(np.asarray(to_numpy(t), np.float32),
                               np.asarray(j, np.float32), atol=tol, rtol=0)


def _caches_close(tcache, jcache, tol):
    assert set(tcache) == set(jcache)
    for kind, leaves in jcache.items():
        if kind == "pos":
            np.testing.assert_array_equal(to_numpy(tcache["pos"]),
                                          np.asarray(leaves))
            continue
        assert set(tcache[kind]) == set(leaves)
        for leaf, arr in leaves.items():
            _close(tcache[kind][leaf], arr, tol)


def _both(arch, layers, missing, S=20, max_len=48, window=None, seed=0):
    """(port rebuilt, port stats, reference rebuilt, reference stats,
    fresh prefill cache) for one wipe."""
    jcfg, jparams, tcfg, tparams = _setup(arch, layers, window)
    tokens = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, size=(2, S)).astype(np.int32)
    _, fresh = JT.forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)},
                          mode="prefill", max_len=max_len)
    fresh = _np_cache(fresh)
    damaged = _wipe(tcfg, fresh, missing)
    has = [i not in missing for i in range(layers)]
    jrebuilt, jstats = jrec.reconstruct_cache(
        jcfg, jparams, {"tokens": jnp.asarray(tokens)},
        jax.tree.map(jnp.asarray, damaged), has, max_len=max_len)
    trebuilt, tstats = trec.reconstruct_cache(
        tcfg, tparams, {"tokens": torch.from_numpy(tokens)},
        params_from_jax(damaged, "cpu"), has, max_len=max_len)
    return trebuilt, tstats, _np_cache(jrebuilt), jstats, fresh


@pytest.mark.parametrize("missing", [[2], [0, 3], "all"],
                         ids=["2", "0-3", "all"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-780m",
                                  "recurrentgemma-2b", "qwen2-moe-a2.7b"])
def test_reconstruct_matches_reference(arch, missing):
    missing = list(range(6)) if missing == "all" else missing
    trebuilt, tstats, jrebuilt, jstats, fresh = _both(arch, 6, missing)
    _caches_close(trebuilt, jrebuilt, LOGIT_TOL)
    _caches_close(trebuilt, fresh, FRESH_TOL)
    assert tstats == {k: int(v) for k, v in jstats.items()}
    assert tstats["full_prefill"] >= len(missing)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "recurrentgemma-2b"])
def test_reconstruct_wrapped_ring(arch):
    """A ring of 8 under a 20-token sequence: layers whose ring survived
    recompute their activations in full (``window_recompute``) and keep the
    ring; lost layers write the ring's tail in place."""
    missing = [1, 3]
    trebuilt, tstats, jrebuilt, jstats, fresh = _both(arch, 6, missing,
                                                      window=8)
    _caches_close(trebuilt, jrebuilt, LOGIT_TOL)
    _caches_close(trebuilt, fresh, FRESH_TOL)
    assert tstats == {k: int(v) for k, v in jstats.items()}
    assert tstats["window_recompute"] >= 1


def test_reconstruct_reuses_kv():
    """Layers with surviving K/V take the Q-only path; the rebuild stops at
    the deepest missing layer."""
    trebuilt, stats, jrebuilt, jstats, fresh = _both(
        "qwen3-1.7b", 6, [2], S=16, max_len=32)
    assert stats["kv_reused"] == 2          # layers 0, 1
    assert stats["full_prefill"] == 1       # layer 2
    assert stats["layers_skipped"] == 3     # layers 3.. untouched
    assert stats["q_only_tokens"] == 32 and stats["prefill_tokens"] == 16
    assert stats == {k: int(v) for k, v in jstats.items()}
    _caches_close(trebuilt, jrebuilt, LOGIT_TOL)


def test_reconstruct_writes_in_place():
    """The rebuild lands in the cache passed in (a view of a serving
    batcher's slots is rebuilt where the batcher reads it)."""
    jcfg, jparams, tcfg, tparams = _setup("qwen3-1.7b", 6)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, jcfg.vocab_size, size=(1, 12)))
    _, fresh = TT.forward(tcfg, tparams, {"tokens": tokens}, mode="prefill",
                          max_len=32)
    big = {kind: {leaf: torch.zeros((a.shape[0], 3) + a.shape[2:],
                                    dtype=a.dtype)
                  for leaf, a in fresh[kind].items()} for kind in ("attn",)}
    big["pos"] = torch.zeros((3,), dtype=torch.int32)
    view = {"attn": {leaf: a[:, 1:2] for leaf, a in big["attn"].items()},
            "pos": big["pos"][1:2]}
    ptrs = [a.data_ptr() for a in big["attn"].values()]
    out, stats = trec.reconstruct_cache(tcfg, tparams, {"tokens": tokens},
                                        view, [False] * 6, max_len=32)
    assert out is view and stats["full_prefill"] == 6
    assert [a.data_ptr() for a in big["attn"].values()] == ptrs
    assert big["pos"].tolist() == [0, 12, 0]
    for leaf in ("k", "v"):
        _close(big["attn"][leaf][:, 1:2], to_numpy(fresh["attn"][leaf]),
               1e-6)
        assert not big["attn"][leaf][:, 0].any()


def test_decode_continues_after_reconstruction():
    """Decode logits after a full rebuild equal those without a crash (the
    reference's 2e-3), and the reference's after its own rebuild (1e-4)."""
    jcfg, jparams, tcfg, tparams = _setup("qwen3-1.7b", 4)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, size=(1, 12))
    lg, cache = TT.forward(tcfg, tparams, {"tokens": torch.from_numpy(toks)},
                           mode="prefill", max_len=32)
    seq = torch.from_numpy(toks)
    tok = torch.argmax(lg, -1).to(torch.int32)
    for _ in range(2):
        seq = torch.cat([seq, tok[:, None].long()], 1)
        lg, cache = TT.decode_step(tcfg, tparams, {"tokens": tok}, cache)
        tok = torch.argmax(lg, -1).to(torch.int32)
    np_cache = to_numpy(cache)
    rebuilt, _ = trec.reconstruct_cache(
        tcfg, tparams, {"tokens": seq}, params_from_jax(np_cache, "cpu"),
        [False] * 4, max_len=32)
    lg2, _ = TT.decode_step(tcfg, tparams, {"tokens": tok}, rebuilt)
    lg_ref, _ = TT.decode_step(tcfg, tparams, {"tokens": tok},
                               params_from_jax(np_cache, "cpu"))
    _close(lg2, to_numpy(lg_ref), FRESH_TOL)
    jrebuilt, _ = jrec.reconstruct_cache(
        jcfg, jparams, {"tokens": jnp.asarray(seq.numpy())},
        jax.tree.map(jnp.asarray, np_cache), [False] * 4, max_len=32)
    jlg, _ = JT.decode_step(jcfg, jparams, {"tokens": jnp.asarray(
        tok.numpy())}, jrebuilt)
    _close(lg2, jlg, LOGIT_TOL)


@settings(max_examples=15, deadline=None)
@given(mask=st.lists(st.booleans(), min_size=4, max_size=4),
       seed=st.integers(0, 50))
def test_property_any_mask_matches_reference(mask, seed):
    missing = [i for i, h in enumerate(mask) if not h]
    trebuilt, tstats, jrebuilt, jstats, fresh = _both(
        "qwen3-1.7b", 4, missing, S=10, max_len=16, seed=seed)
    _caches_close(trebuilt, jrebuilt, LOGIT_TOL)
    _caches_close(trebuilt, fresh, FRESH_TOL)
    assert tstats == {k: int(v) for k, v in jstats.items()}


@pytest.mark.parametrize("S,cap", [(5, 8), (8, 8), (13, 8), (20, 8)])
def test_ring_slot_positions_match_reference(S, cap):
    np.testing.assert_array_equal(
        trec._ring_slot_positions(S, cap).numpy(),
        np.asarray(jrec._ring_slot_positions(S, cap)))


@pytest.mark.parametrize("S", [6, 16])
def test_windowed_ring_attention_matches_reference_and_flash(S):
    """The ring form (the plain version of the windowed Q-only branch) is
    the reference's; on an unwrapped ring (S <= cap, the only one that
    branch sees) it equals causal flash attention with the window over the
    cache's first S rows, which the card runs."""
    jcfg, _, tcfg, _ = _setup("qwen3-1.7b", 2, window=4)
    rng = np.random.default_rng(S)
    cap, hd = 16, tcfg.resolved_head_dim
    q = rng.standard_normal((2, S, tcfg.n_heads, hd)).astype(np.float32)
    kc = rng.standard_normal((2, cap, tcfg.n_kv_heads, hd)).astype(
        np.float32)
    vc = rng.standard_normal(kc.shape).astype(np.float32)
    t = trec._windowed_ring_attention(tcfg, torch.from_numpy(q),
                                      torch.from_numpy(kc),
                                      torch.from_numpy(vc), S)
    j = jrec._windowed_ring_attention(jcfg, jnp.asarray(q), jnp.asarray(kc),
                                      jnp.asarray(vc), S)
    _close(t, j, 1e-5)
    f = fa.flash_attention_plain(
        torch.from_numpy(q).transpose(1, 2),
        torch.from_numpy(kc[:, :S]).transpose(1, 2),
        torch.from_numpy(vc[:, :S]).transpose(1, 2), causal=True,
        window=tcfg.attn_window).transpose(1, 2)
    _close(t, to_numpy(f), 1e-5)


def test_kind_indices_match_reference():
    for arch in ("qwen3-1.7b", "mamba2-780m", "recurrentgemma-2b",
                 "qwen2-moe-a2.7b"):
        cfg = get_arch(arch).reduced(n_layers=6)
        assert TT.layers(cfg) == jrec._kind_indices(
            jget_arch(arch).reduced(n_layers=6))
