"""The pieces around the port's train step, against the JAX package's:
sharding specs and the activation policy, MoE routing per token group
under a policy, the data streams, checkpoints across the two packages, the
train launcher with a resume, and two functions of modules ported earlier
(``simulate_adapter_serving``, ``lora_bytes``).

Specs, data batches, simulator results and byte counts are compared for
equality; model outputs within 1e-5 of their max |value| (float32, sum
order only).
"""
import os
import re
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_arch as jget_arch
from repro.core import adapter_scheduler as jsched
from repro.distributed import context as jctx
from repro.distributed import shardings as jshd
from repro.launch import mesh as jmesh
from repro.lora import adapters as jlora
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro.training import checkpoint as jck
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training import train as jtrain
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_jax, to_numpy
from repro_torch.core import adapter_scheduler as tsched
from repro_torch.distributed import context as tctx
from repro_torch.distributed import shardings as tshd
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as tlaunch
from repro_torch.lora import adapters as tlora
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as TT
from repro_torch.models.layers import _ACTS
from repro_torch.training import checkpoint as tck
from repro_torch.training import data as tdata
from repro_torch.training import optimizer as topt
from repro_torch.training import train as ttrain
from test_torch_stable_init import stable_init

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5


# ---------------------------------------------------------------------------
# sharding specs
# ---------------------------------------------------------------------------

def _jflat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {jax.tree_util.keystr(p): tuple(s) for p, s in leaves}


def _tflat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tflat(v, f"{prefix}['{k}']"))
        return out
    return {prefix: tuple(tree)}


MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "host": None,
}


def _meshes(name):
    """(reference mesh, the port's description of it)."""
    if MESHES[name] is None:
        jm = jmesh.make_host_mesh()
        return jm, tmesh.Mesh(tuple(jm.axis_names),
                              tuple(jm.shape[a] for a in jm.axis_names))
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), tmesh.Mesh(names, sizes)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_specs_match_reference_for_every_arch(mesh):
    """``param_specs`` in all four modes, ``opt_specs``, ``batch_specs``
    and ``cache_specs``, leaf by leaf, for every config at full size (the
    reference's shapes from ``jax.eval_shape``, the port's from meta
    tensors: no weights are drawn)."""
    jm, tm = _meshes(mesh)
    for arch in ARCH_IDS:
        jcfg, tcfg = jget_arch(arch), get_arch(arch)
        jshape = jax.eval_shape(lambda: JT.init_params(
            jcfg, jax.random.PRNGKey(0)))
        tshape = TT.init_params(tcfg, torch.Generator(), device="meta")
        for mode in ("fsdp", "replicated", "model", "2dtp"):
            want = _jflat(jshd.param_specs(jcfg, jshape, jm, mode=mode))
            got = _tflat(tshd.param_specs(tcfg, tshape, tm, mode=mode))
            assert got == want, (arch, mode)
            assert _tflat(tshd.opt_specs(tshd.param_specs(
                tcfg, tshape, tm, mode=mode))) == _jflat(
                jshd.opt_specs(jshd.param_specs(jcfg, jshape, jm,
                                                mode=mode)))
        jcache = jax.eval_shape(lambda: JT.init_cache(jcfg, 4, 256))
        tcache = TT.init_cache(tcfg, 4, 256, device="meta")
        assert _tflat(tshd.cache_specs(tcfg, tcache, tm)) == \
            _jflat(jshd.cache_specs(jcfg, jcache, jm)), arch
    shapes = {"tokens": (4, 32), "labels": (4, 32), "embeds": (4, 32, 8),
              "positions": (4, 32, 3), "last_index": (4,)}
    jb = {k: jax.ShapeDtypeStruct(s, jnp.int32) for k, s in shapes.items()}
    tb = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    for shard_seq in (True, False):
        assert _tflat(tshd.batch_specs(None, tb, tm, shard_seq=shard_seq)) \
            == _jflat(jshd.batch_specs(None, jb, jm, shard_seq=shard_seq))


def test_policy_specs_and_token_groups_match_reference():
    for mesh in ("16x16", "2x16x16", "host"):
        jm, tm = _meshes(mesh)
        for kw in ({}, {"dp_axes": ("pod", "data")},
                   {"vocab_axis": "model", "ff_axis": "model"},
                   {"seq_axis": None}):
            jp = jctx.ShardingPolicy(jm, **kw)
            tp = tctx.ShardingPolicy(tm, **kw)
            assert tp.token_groups == jp.token_groups, (mesh, kw)
            for role in ("act", "ffh", "heads", "logits", "tok"):
                for nd in (2, 3, 4):
                    assert tuple(tp.spec(role, nd)) == \
                        tuple(jp.spec(role, nd)), (mesh, kw, role, nd)


def test_mesh_helpers_and_named():
    for n in (1, 2, 24, 26, 48, 64, 80):
        assert tmesh.pipeline_stages_for(n) == jmesh.pipeline_stages_for(n)
    for name in ("16x16", "2x16x16"):
        jm, tm = _meshes(name)
        assert tmesh.data_axes(tm) == jmesh.data_axes(jm)
    assert tmesh.make_production_mesh().shape == {"data": 16, "model": 16}
    assert tmesh.make_production_mesh(multi_pod=True).size == 512
    assert tmesh.make_pipeline_mesh(4).shape == {"data": 64, "stage": 4}
    host = tmesh.make_host_mesh(devices=[torch.device("cpu")])
    assert host.shape == {"data": 1, "model": 1}
    spec = {"a": tshd.P("data", None), "b": {"c": tshd.P()}}
    assert tshd.named(host, spec) == {"a": torch.device("cpu"),
                                      "b": {"c": torch.device("cpu")}}
    with pytest.raises(ValueError):
        tshd.named(tmesh.make_production_mesh(), spec)
    with pytest.raises(ValueError):
        tmesh.make_pipeline_mesh(3)
    x = torch.ones(2, 3)
    with tctx.use_policy(tctx.ShardingPolicy(tmesh.Mesh(("data", "model"),
                                                        (2, 2)))):
        assert tctx.constrain(x, "act") is x
        assert tctx.get_policy().token_groups == 4
    assert tctx.get_policy() is None


# ---------------------------------------------------------------------------
# MoE routing per token group
# ---------------------------------------------------------------------------

def _moe_pair(cf=0.5):
    jcfg = jget_arch("qwen2-moe-a2.7b").reduced(capacity_factor=cf)
    tcfg = get_arch("qwen2-moe-a2.7b").reduced(capacity_factor=cf)
    with stable_init():
        jparams = JT.init_params(jcfg, jax.random.PRNGKey(8))
    return jcfg, jparams, tcfg, params_from_jax(
        jax.tree.map(np.asarray, jparams), "cpu")


def _ref_keep(jcfg, router, xt, G):
    """The reference's dropped pairs, from its own routing primitives
    (``jax.nn.softmax`` and ``jax.lax.top_k`` of its router product) and
    its per-group queue rule: a pair is kept when fewer than C pairs of
    its group chose its expert before it."""
    T, D = xt.shape
    Tg = T // G
    C = jmoe.moe_capacity(Tg, jcfg)
    probs = jax.nn.softmax((jnp.asarray(xt).reshape(G, Tg, D)
                            @ router).astype(jnp.float32), axis=-1)
    _, top_e = jax.lax.top_k(probs, jcfg.top_k)
    top_e = np.asarray(top_e).reshape(G, Tg * jcfg.top_k)
    keep = np.zeros_like(top_e, bool)
    for g in range(G):
        seen = {}
        for i, e in enumerate(top_e[g]):
            keep[g, i] = seen.get(e, 0) < C
            seen[e] = seen.get(e, 0) + 1
    return top_e.reshape(T, jcfg.top_k), keep.reshape(T, jcfg.top_k)


def test_moe_routes_per_token_group_under_a_policy():
    """Under the reference's ``ShardingPolicy(AbstractMesh((2, 2)))`` and
    the port's counterpart, at capacity factor 0.5: the FFN's output, its
    load-balance loss and its dropped pairs equal the reference's, and
    grouped routing differs from global routing (so the groups matter
    here)."""
    jcfg, jparams, tcfg, tparams = _moe_pair()
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["moe"]["mlp"])
    tp = TT.layer_params(tparams["blocks"]["moe"]["mlp"], 0)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((4, 16, jcfg.d_model)).astype(np.float32)
    jpol = jctx.ShardingPolicy(AbstractMesh((2, 2), ("data", "model")))
    tpol = tctx.ShardingPolicy(tmesh.Mesh(("data", "model"), (2, 2)))
    act = _ACTS[tcfg.act]
    with jctx.use_policy(jpol):
        jy, jaux = jmoe.moe_mlp(jcfg, jp, jnp.asarray(x), jax.nn.silu)
    with tctx.use_policy(tpol), tmoe.record_routing() as rec:
        ty, taux = tmoe.moe_mlp(tcfg, tp, torch.from_numpy(x), act)
    scale = np.abs(np.asarray(jy)).max()
    assert np.abs(ty.numpy() - np.asarray(jy)).max() <= TOL * scale
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    top_e, keep = _ref_keep(jcfg, jp["router"], x.reshape(-1, jcfg.d_model),
                            4)
    np.testing.assert_array_equal(rec[0][0].numpy(), top_e)
    np.testing.assert_array_equal(rec[0][1].numpy(), keep)
    assert 0 < (~keep).sum()
    with tmoe.record_routing() as rec_global:
        tg, _ = tmoe.moe_mlp(tcfg, tp, torch.from_numpy(x), act)
    assert not np.array_equal(rec_global[0][1].numpy(), keep)
    assert np.abs(tg.numpy() - ty.numpy()).max() > 100 * TOL * scale


def test_moe_model_under_a_policy_matches_reference():
    """The whole train forward under the policies, eager and jitted on the
    reference's side: logits and aux within 1e-5 of max |value|."""
    jcfg, jparams, tcfg, tparams = _moe_pair()
    toks = np.random.default_rng(10).integers(0, jcfg.vocab_size, (4, 16))
    jpol = jctx.ShardingPolicy(AbstractMesh((2, 2), ("data", "model")))
    tpol = tctx.ShardingPolicy(tmesh.Mesh(("data", "model"), (2, 2)))
    fwd = jax.jit(lambda p, b: JT.forward(jcfg, p, b, mode="train"))
    with jctx.use_policy(jpol):
        jl, jaux = fwd(jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    with tctx.use_policy(tpol):
        tl, taux = TT.forward(tcfg, tparams,
                              {"tokens": torch.from_numpy(toks)},
                              mode="train")
    scale = np.abs(np.asarray(jl)).max()
    assert np.abs(tl.numpy() - np.asarray(jl)).max() <= TOL * scale
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    gl, gaux = TT.forward(tcfg, tparams, {"tokens": torch.from_numpy(toks)},
                          mode="train")
    assert float(gaux) != float(taux) or not torch.equal(gl, tl)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def _same_batches(a, b, n):
    for _ in range(n):
        ba, bb = a.next_batch(), b.next_batch()
        assert set(ba) == set(bb)
        for k in ba:
            assert ba[k].dtype == bb[k].dtype
            np.testing.assert_array_equal(ba[k], bb[k])


@pytest.mark.parametrize("structured", [True, False])
def test_synthetic_lm_matches_reference_with_shard_and_restore(structured):
    kw = dict(vocab_size=97, seq_len=12, batch_size=3, seed=5,
              structured=structured)
    j, t = jdata.SyntheticLM(**kw), tdata.SyntheticLM(**kw)
    _same_batches(j, t, 3)
    assert t.state() == j.state()
    js, ts = j.shard(1, 4), t.shard(1, 4)
    _same_batches(js, ts, 2)
    fresh = tdata.SyntheticLM(**kw)
    fresh.restore(t.state())
    _same_batches(j, fresh, 2)
    with pytest.raises(ValueError):
        tdata.SyntheticLM(**{**kw, "seed": 6}).restore(t.state())


def test_corpus_lm_matches_reference_with_restore():
    text = "the quick brown fox jumps over the lazy dog. " * 20
    j = jdata.CorpusLM(text, seq_len=16, batch_size=4, seed=3)
    t = tdata.CorpusLM(text, seq_len=16, batch_size=4, seed=3)
    assert t.vocab_size == j.vocab_size == 256
    _same_batches(j, t, 3)
    fresh = tdata.CorpusLM(text, seq_len=16, batch_size=4, seed=3)
    fresh.restore(t.state())
    _same_batches(j, fresh, 2)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _jstate(arch="qwen3-1.7b", dtype=jnp.float32):
    cfg = jget_arch(arch).reduced()
    with stable_init():
        params = JT.init_params(cfg, jax.random.PRNGKey(12), dtype)
    st = jtrain.TrainState(params, jopt.init_opt_state(params))
    # moments that are not zero, a step that is not 0
    m = jax.tree.map(lambda p: p.astype(jnp.float32) * 0.5, params)
    v = jax.tree.map(lambda p: jnp.abs(p.astype(jnp.float32)) * 0.25,
                     params)
    return cfg, st._replace(opt=jopt.OptState(jnp.asarray(7, jnp.int32),
                                              m, v))


def _port_template(jstate):
    p = params_from_jax(jax.tree.map(np.asarray, jstate.params), "cpu")
    return ttrain.TrainState(p, topt.init_opt_state(p))


def _same_state(tstate, jstate):
    assert int(tstate.opt.step) == int(jstate.opt.step)
    for name, t, j in (("params", tstate.params, jstate.params),
                       ("m", tstate.opt.m, jstate.opt.m),
                       ("v", tstate.opt.v, jstate.opt.v)):
        for a, b in zip(topt.tree_leaves(t), jax.tree.leaves(j)):
            assert str(a.dtype).split(".")[-1] == str(b.dtype), name
            np.testing.assert_array_equal(to_numpy(a),
                                          np.asarray(b, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_restore_across_packages(tmp_path, dtype):
    """A reference checkpoint restores into the port's ``TrainState`` and a
    port checkpoint into the reference's, bf16 params widened on disk and
    narrowed back."""
    _, jstate = _jstate(dtype=jnp.dtype(dtype))
    jck.Checkpointer(str(tmp_path / "j")).save(
        7, jstate, extra={"data": {"step": 3}, "step": 7})
    tstate, extra = tck.Checkpointer(str(tmp_path / "j")).restore(
        _port_template(jstate))
    assert extra == {"data": {"step": 3}, "step": 7}
    _same_state(tstate, jstate)

    tck.Checkpointer(str(tmp_path / "t")).save(7, tstate, extra=extra)
    template = jtrain.TrainState(jstate.params,
                                 jopt.init_opt_state(jstate.params))
    back, extra2 = jck.Checkpointer(str(tmp_path / "t")).restore(template)
    assert extra2 == extra
    _same_state(tstate, back)
    # the same files: names, shapes and dtypes of the manifests
    names = sorted(os.listdir(tmp_path / "t" / "step_000000007"))
    assert names == sorted(os.listdir(tmp_path / "j" / "step_000000007"))
    jman = (tmp_path / "j" / "step_000000007" / "MANIFEST.json").read_text()
    tman = (tmp_path / "t" / "step_000000007" / "MANIFEST.json").read_text()
    assert jman == tman


def test_checkpoint_latest_keep_and_async_error(tmp_path):
    _, jstate = _jstate()
    state = _port_template(jstate)
    ck = tck.Checkpointer(str(tmp_path / "c"), keep=2)
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore(state)
    for step in (1, 2, 3):
        ck.save(step, state, extra={"step": step}, async_=True)
    ck.wait()
    entries = sorted(os.listdir(tmp_path / "c"))
    # keep=2 steps, LATEST published by rename, no temporaries left
    assert entries == ["LATEST", "step_000000002", "step_000000003"]
    assert (tmp_path / "c" / "LATEST").read_text() == "step_000000003"
    assert ck.latest_step() == 3
    _, extra = ck.restore(state, step=2)
    assert extra == {"step": 2}
    # an async write that fails surfaces at the next wait(), once
    with mock.patch.object(tck.np, "savez",
                           side_effect=OSError("disk full")):
        ck.save(4, state, async_=True)
        with pytest.raises(OSError, match="disk full"):
            ck.wait()
    ck.wait()
    assert ck.latest_step() == 3
    assert not any(e.startswith(".") for e in os.listdir(tmp_path / "c"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_async_save_snapshots_the_tree(tmp_path, dtype):
    """An async save writes the tree as it was when ``save`` returned: an
    AdamW step that updates params, m and v in place while the write runs
    (held back here until that step is done) does not reach the file."""
    _, jstate = _jstate(dtype=jnp.dtype(dtype))
    state = _port_template(jstate)
    before = [to_numpy(t).copy() for t in topt.tree_leaves(state)]
    ck = tck.Checkpointer(str(tmp_path / "c"))
    stepped = threading.Event()
    savez = np.savez

    def held_savez(*args, **kwargs):
        assert stepped.wait(30)
        savez(*args, **kwargs)

    with mock.patch.object(tck.np, "savez", side_effect=held_savez):
        ck.save(1, state, async_=True)
        grads = topt.tree_map(torch.ones_like, state.params)
        topt.adamw_update(topt.AdamWConfig(lr=1e-2, warmup_steps=1,
                                           total_steps=4),
                          state.params, grads, state.opt)
        stepped.set()
        ck.wait()
    changed = [to_numpy(t) for t in topt.tree_leaves(state)]
    assert any(not np.array_equal(a, b) for a, b in zip(before, changed))
    restored, _ = ck.restore(_port_template(jstate))
    for a, b in zip(topt.tree_leaves(restored), before):
        np.testing.assert_array_equal(to_numpy(a), b)


def test_resumed_training_equals_uninterrupted(tmp_path):
    """Three steps, a checkpoint, a fresh state and data stream restored
    from it, three more: equal to six steps straight through."""
    _, jstate = _jstate()
    tcfg = get_arch("qwen3-1.7b").reduced()
    opt = topt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6)
    step = ttrain.make_train_step(tcfg, opt, remat=False)

    def fresh():
        return (_port_template(jstate),
                tdata.SyntheticLM(tcfg.vocab_size, 16, 2, seed=1))

    def run(state, ds, n):
        for _ in range(n):
            state, m = step(state, {k: torch.from_numpy(v)
                                    for k, v in ds.next_batch().items()})
        return state, float(m["loss"])

    straight, loss6 = run(*fresh(), 6)
    state, ds = fresh()
    state, _ = run(state, ds, 3)
    ck = tck.Checkpointer(str(tmp_path / "r"))
    ck.save(3, state, extra={"data": ds.state(), "step": 3})
    state, ds = fresh()
    state, extra = ck.restore(state)
    ds.restore(extra["data"])
    resumed, loss_r = run(state, ds, 3)
    assert loss_r == loss6
    for a, b in zip(topt.tree_leaves(resumed), topt.tree_leaves(straight)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _launch(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--device", "cpu", *args], env=env, cwd=cwd,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_launcher_resume_equals_uninterrupted(tmp_path):
    """``launch.train --device cpu --steps 4`` with a checkpoint every 2
    steps; then the same directory as a crash after step 2 would leave it
    (step 4 gone, LATEST at step 2) resumed with ``--resume``: the step-4
    loss printed and the step-4 checkpoint equal the uninterrupted run's."""
    run = ["--arch", "qwen3-1.7b", "--steps", "4", "--batch", "2", "--seq",
           "16", "--ckpt-every", "2"]
    a, b = tmp_path / "a", tmp_path / "b"
    out_a = _launch(run + ["--ckpt-dir", str(a)], tmp_path)
    shutil.copytree(a, b)
    shutil.rmtree(b / "step_000000004")
    (b / "LATEST").write_text("step_000000002")
    out_b = _launch(run + ["--ckpt-dir", str(b), "--resume"], tmp_path)
    assert "resumed from step 2" in out_b

    def loss4(out):
        return re.search(r"step +4 loss (\S+)", out).group(1)
    assert loss4(out_b) == loss4(out_a)
    with np.load(a / "step_000000004" / "arrays.npz") as za, \
            np.load(b / "step_000000004" / "arrays.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k])


@pytest.mark.parametrize("flag", ["--production-mesh", "--distributed-init"])
def test_launcher_refuses_many_cards(flag):
    with pytest.raises(SystemExit, match="one"):
        tlaunch.main([flag, "--device", "cpu"])


# ---------------------------------------------------------------------------
# simulate_adapter_serving, lora_bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["epoch", "eager"])
def test_simulate_adapter_serving_matches_reference(policy):
    for rps, switch, seed in ((5.0, 0.2, 0), (20.0, 0.5, 3), (40.0, 0.05, 7)):
        def make(mod):
            return (mod.EpochSchedulerPolicy(epoch_budget=8, max_batch=8)
                    if policy == "epoch" else mod.EagerPolicy(max_batch=8))
        kw = dict(rps=rps, horizon=10.0, n_adapters=3, switch_prob=switch,
                  seed=seed)
        want = jsched.simulate_adapter_serving(make(jsched), **kw)
        got = tsched.simulate_adapter_serving(make(tsched), **kw)
        assert got == want
        assert got["n"] > 0


@pytest.mark.parametrize("rank", [8, 16])
def test_lora_bytes_matches_reference(rank):
    for arch in ARCH_IDS:
        cfg = jget_arch(arch)
        assert tlora.lora_bytes(get_arch(arch), rank) == \
            jlora.lora_bytes(cfg, rank), arch
        assert tlora.lora_bytes(get_arch(arch), rank, 4) == \
            jlora.lora_bytes(cfg, rank, 4), arch
