"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
``repro.models.moe``.

Reduced qwen2-moe-a2.7b (4 experts, top-2, one shared expert) and
phi3.5-moe (4 experts, top-2, no shared expert) in float32; the weights
are the reference's ``init_moe_mlp`` converted with ``params_from_jax``,
the inputs numpy from a seed.  The two packages differ only in the order
of float32 sums: outputs within 1e-5 of max |y| (the reference's init
draws the reduced experts with std 1/sqrt(E) = 0.5 and the one shared
expert with std 1, so y reaches a few hundred, where one float32 ulp is
3e-5), load-balance losses within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.models import moe as jmoe
from repro.models.layers import _ACTS as J_ACTS
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_jax, to_numpy
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import _ACTS as T_ACTS

TOL = 1e-5
ARCHS = ("qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b")


def _setup(arch, seed=0, B=2, S=24, zero_router=False):
    jcfg = jget_arch(arch).reduced()
    tcfg = get_arch(arch).reduced()
    jp = jmoe.init_moe_mlp(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    if zero_router:
        jp = {**jp, "router": jnp.zeros_like(jp["router"])}
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(seed).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    return jcfg, jp, tcfg, tp, x


def _close(t, j, tol=TOL):
    """Within ``tol`` of max |j| (and ``tol`` itself for a scalar)."""
    j = np.asarray(j, np.float32)
    np.testing.assert_allclose(np.asarray(to_numpy(t), np.float32), j,
                               atol=tol * max(1.0, float(np.abs(j).max())),
                               rtol=0)


def _run(arch, *, dropless, capacity_factor=None, **kw):
    jcfg, jp, tcfg, tp, x = _setup(arch, **kw)
    act = jcfg.act
    yj, auxj = jmoe.moe_mlp(jcfg, jp, jnp.asarray(x), J_ACTS[act],
                            dropless=dropless,
                            capacity_factor=capacity_factor)
    with tmoe.record_routing() as rec:
        yt, auxt = tmoe.moe_mlp(tcfg, tp, torch.from_numpy(x), T_ACTS[act],
                                dropless=dropless,
                                capacity_factor=capacity_factor)
    return yt, auxt, yj, auxj, rec, tcfg


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_path_with_drops_matches(arch):
    """B 2, S 24 at capacity factor 0.5: C = 16 slots an expert for 24
    (token, choice) pairs an expert on average, so pairs drop.  With and
    without shared experts."""
    yt, auxt, yj, auxj, rec, cfg = _run(arch, dropless=False,
                                        capacity_factor=0.5)
    jc = dataclasses.replace(jget_arch(arch).reduced(), capacity_factor=0.5)
    assert tmoe.moe_capacity(48, cfg, 0.5) == jmoe.moe_capacity(48, jc) == 16
    [(top_e, keep)] = rec
    assert top_e.shape == keep.shape == (48, cfg.top_k)
    assert 0 < int((~keep).sum()) < keep.numel()      # some pairs dropped
    _close(yt, yj)
    _close(auxt, auxj)
    assert auxt.dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_path_without_drops_matches(arch):
    """The reduced configs' own capacity factor (8): nothing drops."""
    yt, auxt, yj, auxj, rec, _ = _run(arch, dropless=False, seed=1)
    assert bool(rec[0][1].all())
    _close(yt, yj)
    _close(auxt, auxj)


@pytest.mark.parametrize("arch", ARCHS)
def test_dropless_matches(arch):
    yt, auxt, yj, auxj, rec, _ = _run(arch, dropless=True, seed=2)
    _close(yt, yj)
    _close(auxt, auxj)


@pytest.mark.parametrize("dropless", [False, True],
                         ids=["capacity", "dropless"])
@pytest.mark.parametrize("arch", ARCHS)
def test_tied_router_picks_lowest_experts(arch, dropless):
    """A zero router ties every expert: the reference's top-k takes
    experts 0..K-1 for every token, and so must the port's."""
    yt, auxt, yj, auxj, rec, cfg = _run(arch, dropless=dropless, seed=3,
                                        zero_router=True)
    [(top_e, _)] = rec
    want = torch.arange(cfg.top_k).expand_as(top_e)
    assert torch.equal(top_e, want)
    _close(yt, yj)
    _close(auxt, auxj)


@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25, 8.0])
@pytest.mark.parametrize("T", [1, 7, 48, 512])
def test_capacity_matches(T, cf):
    for arch in ("qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b"):
        jc = dataclasses.replace(jget_arch(arch), capacity_factor=cf)
        assert tmoe.moe_capacity(T, get_arch(arch), cf) == \
            jmoe.moe_capacity(T, jc)


def test_init_layout_matches_reference():
    """The port's own init has the reference's leaves, shapes and dtypes,
    and the reference's scales: std 1/sqrt(E) for the routed experts
    (the fan-in is the leading axis of the per-layer (E, D, F) shape)."""
    jcfg = jget_arch("qwen2-moe-a2.7b").reduced()
    jp = jax.tree.map(np.asarray, jmoe.init_moe_mlp(jax.random.PRNGKey(0),
                                                    jcfg, jnp.float32))
    tp = to_numpy(tmoe.init_moe_mlp(torch.Generator().manual_seed(0),
                                    get_arch("qwen2-moe-a2.7b").reduced(),
                                    3, torch.float32, "cpu"))
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (path, a), (_, b) in zip(flat_j, flat_t):
        assert (3,) + a.shape == b.shape and a.dtype == b.dtype
        # truncated normal on [-2, 2]: std 0.88 of the scale
        np.testing.assert_allclose(b.std(), a.std(), rtol=0.25,
                                   err_msg=str(path))
