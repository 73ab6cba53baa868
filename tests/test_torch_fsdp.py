"""Training across devices on the CPU: the port's sharded train path over a
``gloo`` process group, one process a rank (``tests/torch_fsdp_worker.py``
under ``torchrun``), against the reference's single-device runs.

The reference's own claims (``tests/test_distributed.py``): a sharded
forward equals the single-device forward, and a state trained and saved
on more devices restores value for value onto fewer and keeps training.
Its sharded run raises ``ShardingTypeError`` on jax 0.9.0 (the embedding
gather), so the oracle is its single-device run, as its tests state the
claim.  Weights are the reference's under ``stable_init``, converted with
``params_from_jax``; batches come from numpy with a seed.

One ``torchrun`` of 4 ranks runs every 4-rank check (MoE on (2, 2)
among them), then one of 2 ranks the checks of 2 (the elastic restore of
the 4-rank checkpoint and MoE on (2, 1)); the launcher runs under
``torchrun`` beside them.  Tolerances:

  * (a) logits within 2e-4 of the reference's (its own bound);
  * (b) losses within 1e-5 relative; every parameter, m and v within 1e-4
    of its leaf's max |x| after three steps;
  * (c), (d) losses within 1e-5 relative; every gradient leaf within 1e-4
    of its max |g| (against the reference where its gradient is finite;
    qwen2-moe on (2, 2) against both under a (2, 2) policy);
  * the elastic restore exact; its next step as (b);
  * the launcher's printed losses equal, its final checkpoint as (b).
"""
import contextlib
import dataclasses
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import get_arch as jget_arch
from repro.distributed import context as jctx
from repro.models import transformer as JT
from repro.training import checkpoint as jck
from repro.training import optimizer as jopt
from repro.training import train as jtrain
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_jax, to_numpy
from repro_torch.distributed import shardings as tshd
from repro_torch.distributed.context import ShardingPolicy, use_policy
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import Mesh
from repro_torch.training import checkpoint as tck
from repro_torch.training import optimizer as topt
from repro_torch.training import train as ttrain
from repro_torch.training.data import SyntheticLM
from test_torch_stable_init import stable_init
from test_torch_training import (_batch, _finite_part, _j, _np, _t,
                                 _tree_close)

ROOT = Path(__file__).resolve().parents[1]
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
LOSS_RTOL = 1e-5
TOL = 1e-4
LAUNCH = ["-m", "repro_torch.launch.train", "--device", "cpu", "--steps",
          "3", "--batch", "4", "--seq", "16"]


def _draw(arch, key, **over):
    jcfg = jget_arch(arch).reduced(**over)
    with stable_init():
        jparams = JT.init_params(jcfg, jax.random.PRNGKey(key))
    return jcfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams),
                                          "cpu")


def _torchrun(n, args, log: Path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    f = open(log, "w")
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), *map(str, args)],
        env=env, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT, text=True), f


def _finish(proc, timeout=240):
    p, f = proc
    try:
        rc = p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.kill()
        rc = p.wait()
    f.close()
    return rc, Path(f.name).read_text()


def _reference_steps(jcfg, jparams, batches, accum):
    opt = jopt.AdamWConfig(**OPT)
    step = jax.jit(jtrain.make_train_step(jcfg, opt, remat=False,
                                          accum=accum))
    st = jtrain.TrainState(jparams, jopt.init_opt_state(jparams))
    metrics = []
    for b in batches:
        st, m = step(st, _j(b))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, st


def _reference_grads(jcfg, jparams, batch):
    (loss, _), grads = jax.jit(jax.value_and_grad(
        jtrain.make_loss_fn(jcfg, remat=False), has_aux=True))(
            jparams, _j(batch))
    return float(loss), _np(grads)


def _port_grads(cfg, params, batch, policy=None):
    with use_policy(policy):
        (loss, _), grads = ttrain.value_and_grad(
            ttrain.make_loss_fn(cfg, remat=False))(params, _t(batch))
    return float(loss), grads


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every multi-rank run of the module, once: the 4-rank worker, the
    launcher under torchrun (2 ranks; and with --production-mesh), then
    the 2-rank worker; the references are computed while they run."""
    d = tmp_path_factory.mktemp("fsdp")
    rng = np.random.default_rng(31)
    job, ref = {"opt_cfg": OPT}, {}

    jq, jqp, tq = _draw("qwen3-1.7b", 3, n_layers=4, vocab_size=256)
    qbatch = {"tokens": rng.integers(0, 256, (4, 32)).astype(np.int32)}
    job["qwen3"] = {"params": tq, "batch": _t(qbatch)}

    jo, jop, to = _draw("pipeboost-opt-1.3b", 5)
    # accum 2 takes twice the rows, so its microbatches have accum 1's
    # shapes (DTensor's sharding choices, made once a shape, are reused)
    obatches = {a: [_batch(jo, rng, B=8 * a, S=16) for _ in range(3)]
                for a in (1, 2)}
    job["opt"] = {"params": to, "batches": {
        a: [_t(b) for b in bs] for a, bs in obatches.items()}}

    grads_in = {}
    for arch, key in (("mamba2-780m", 7), ("recurrentgemma-2b", 9),
                      ("qwen2-moe-a2.7b", 11)):
        jc, jp, tp = _draw(arch, key)
        b = _batch(jc, rng, B=4, S=32)
        grads_in[arch] = (jc, jp, tp, b)
        job[arch] = {"params": tp, "batch": _t(b)}

    je, jep, te = _draw("qwen3-1.7b", 0, n_layers=2, vocab_size=256)
    job["elastic"] = {"params": te}

    kernels = np.random.default_rng(37)
    job["kernels"] = {
        "q": kernels.standard_normal((4, 32, 4, 64)),
        "kv": kernels.standard_normal((2, 4, 32, 2, 64)),
        "x": kernels.standard_normal((4, 32, 4, 16)),
        "dt": kernels.uniform(0.01, 0.2, (4, 32, 4)),
        "A": -kernels.uniform(0.5, 2.0, (4,)),
        "BC": kernels.standard_normal((2, 4, 32, 128)),
        "log_a": -kernels.uniform(0.01, 0.5, (4, 32, 24)),
        "bx": kernels.standard_normal((4, 32, 24)),
        "dy": kernels.standard_normal((4, 32, 4, 64)),
    }
    job["kernels"] = {k: torch.from_numpy(v).float()
                      for k, v in job["kernels"].items()}
    torch.save(job, d / "inputs.pt")

    worker = ["tests/torch_fsdp_worker.py", "--job", d]
    w4 = _torchrun(4, worker + ["--part", "world4"], d / "world4.log")
    l2 = _torchrun(2, LAUNCH + ["--ckpt-dir", d / "l2"], d / "l2.log")
    pm = _torchrun(2, LAUNCH + ["--production-mesh"], d / "pm.log")

    # the references, while the ranks run
    ref["qwen3"], _ = JT.forward(jq, jqp, _j(qbatch), mode="train")
    for accum in (1, 2):
        ref[f"opt_accum{accum}"] = _reference_steps(
            jo, jop, obatches[accum], accum)
    for arch, (jc, jp, tp, b) in grads_in.items():
        tcfg = get_arch(arch).reduced()
        if arch != "qwen2-moe-a2.7b":
            ref[arch] = {"port": _port_grads(tcfg, tp, b),
                         "reference": _reference_grads(jc, jp, b)}
            continue
        # MoE routes per token group: both sides under a policy of the
        # mesh, whose groups are its dp x seq ranks
        for shape in ((2, 1), (2, 2)):
            pol = ShardingPolicy(Mesh(("data", "model"), shape))
            ref[f"{arch} {shape}"] = {"port": _port_grads(tcfg, tp, b, pol)}
        jpol = jctx.ShardingPolicy(AbstractMesh((2, 2), ("data", "model")))
        with jctx.use_policy(jpol):
            ref[f"{arch} (2, 2)"]["reference"] = _reference_grads(jc, jp, b)
    out1 = io.StringIO()
    with contextlib.redirect_stdout(out1):
        tlaunch.main(LAUNCH[2:] + ["--ckpt-dir", str(d / "l1")])

    res = {"dir": d, "ref": ref, "refs": (jq, jo, je, jep), "launch1":
           out1.getvalue()}
    res["world4_rc"], res["world4_log"] = _finish(w4)
    if res["world4_rc"] == 0:
        w2 = _torchrun(2, worker + ["--part", "world2"], d / "world2.log")
        res["world2_rc"], res["world2_log"] = _finish(w2)
    res["l2_rc"], res["l2_log"] = _finish(l2)
    res["pm_rc"], res["pm_log"] = _finish(pm)
    return res


def _out(runs, part):
    rc = runs.get(f"{part}_rc")
    assert rc == 0, (rc, runs.get(f"{part}_log", "")[-4000:])
    return torch.load(runs["dir"] / f"{part}.pt", weights_only=False)


def _close(got, want, tol, what):
    got = np.asarray(to_numpy(got), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale or err == 0.0, \
        f"{what}: max|diff| {err} > {tol} * {scale}"


# ---------------------------------------------------------------------------
# (a) the sharded forward
# ---------------------------------------------------------------------------

def test_sharded_logits_match_reference_single_device(runs):
    """The reduced qwen3 (4 layers, vocab 256) on a (2, 2) mesh, the
    sequence split over 'model': the logits come out sharded (dp, seq),
    not whole, and within 2e-4 of the reference's single-device forward."""
    out = _out(runs, "world4")
    assert out["qwen3_placements"] == ["Shard(dim=0)", "Shard(dim=1)"]
    assert out["qwen3_local_shape"] == (2, 16, 256)
    err = np.abs(out["qwen3_logits"].numpy()
                 - np.asarray(runs["ref"]["qwen3"])).max()
    assert err < 2e-4, err


def test_constrain_roles_on_real_shards(runs):
    """Every role of the (2, 2) policy pins a DTensor to its spec's
    placements on real shards (the residual stream split (dp, seq)) and
    keeps its values; MoE's token groups are the dp x seq ranks, 4."""
    out = _out(runs, "world4")
    assert set(out["roles"]) == {"act", "ffh", "heads", "logits", "tok"}
    for role, (got, want, same) in out["roles"].items():
        assert got == want and same, role
    assert out["roles"]["act"][0] == ["Shard(dim=0)", "Shard(dim=1)"]
    assert out["token_groups"] == 4


# ---------------------------------------------------------------------------
# (b) whole sharded train steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh,accum", [("4x1", 1), ("4x1", 2), ("2x2", 1),
                                        ("2x2", 2)])
def test_sharded_train_steps_match_reference_jit(runs, mesh, accum):
    """Three steps of the reduced opt-1.3b, the state sharded FSDP as
    DTensors on (4, 1) (the launcher's host mesh) and (2, 2), each batch
    split into microbatches before it is distributed: every metric of
    every step, and the parameters, m and v after step 3, against the
    reference's single-device jitted step."""
    got = _out(runs, "world4")[f"opt_{mesh}_accum{accum}"]
    want_m, want_st = runs["ref"][f"opt_accum{accum}"]
    for n, (g, w) in enumerate(zip(got["metrics"], want_m), 1):
        for k in ("loss", "ce", "tokens", "lr", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL,
                                       atol=1e-7, err_msg=f"step {n} {k}")
    st = got["state"]
    assert int(st.opt.step) == 3
    for name, g, w in (("params", st.params, want_st.params),
                       ("m", st.opt.m, want_st.opt.m),
                       ("v", st.opt.v, want_st.opt.v)):
        _tree_close(g, _np(w), TOL, name)


# ---------------------------------------------------------------------------
# (c), (d) loss and gradients of the other families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-2b"])
def test_sharded_loss_and_grads_match_one_process(runs, arch):
    """mamba2 and recurrentgemma reduced on (2, 2): the SSD and RG-LRU
    scans run on each rank's rows with the sequence gathered.  Loss and
    every gradient leaf against the port's one-process run, and against
    the reference's where its gradient is finite (its mamba2 gradient is
    NaN in part: ``test_torch_training._finite_part``)."""
    got = _out(runs, "world4")[arch]
    loss, grads = runs["ref"][arch]["port"]
    np.testing.assert_allclose(got["loss"], loss, rtol=LOSS_RTOL)
    _tree_close(got["grads"], to_numpy(grads), TOL, arch)
    jloss, jgrads = runs["ref"][arch]["reference"]
    np.testing.assert_allclose(got["loss"], jloss, rtol=LOSS_RTOL)
    _tree_close(got["grads"], _finite_part(jgrads, grads), TOL, arch)


def test_moe_sharded_matches_one_process_under_a_policy(runs):
    """qwen2-moe reduced on (2, 1): each rank routes its own token group
    (``moe._device_groups``) over real shards.  Loss and gradients against
    the one-process run under a (2, 1) policy, whose two groups are the
    same tokens (``test_torch_train_infra`` ties that run to the
    reference's)."""
    got = _out(runs, "world2")["qwen2-moe-a2.7b"]
    loss, grads = runs["ref"]["qwen2-moe-a2.7b (2, 1)"]["port"]
    np.testing.assert_allclose(got["loss"], loss, rtol=LOSS_RTOL)
    _tree_close(got["grads"], to_numpy(grads), TOL, "moe")


def test_moe_sequence_split_routes_the_reference_groups(runs):
    """qwen2-moe reduced on (2, 2), the sequence split over 'model': the
    token-major fold gathers the sequence inside each data shard and
    splits the rows over 'model', so rank (i, j) routes the reference's
    contiguous group 2i + j.  Loss and every gradient leaf against the
    one-process run under a (2, 2) policy (4 contiguous groups) and the
    reference's under its (2, 2) policy."""
    got = _out(runs, "world4")["qwen2-moe-a2.7b"]
    want = runs["ref"]["qwen2-moe-a2.7b (2, 2)"]
    loss, grads = want["port"]
    np.testing.assert_allclose(got["loss"], loss, rtol=LOSS_RTOL)
    _tree_close(got["grads"], to_numpy(grads), TOL, "moe (2, 2)")
    jloss, jgrads = want["reference"]
    np.testing.assert_allclose(got["loss"], jloss, rtol=LOSS_RTOL)
    _tree_close(got["grads"], _finite_part(jgrads, grads), TOL,
                "moe (2, 2) against the reference")


# ---------------------------------------------------------------------------
# the kernels' DTensor route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["flash_attention", "ssd_scan",
                                    "rglru_scan"])
def test_kernel_route_on_rows_matches_plain(runs, kernel):
    """Each train-path kernel given DTensors split (dp, seq) on (2, 2)
    runs on each rank's rows with the sequence gathered: outputs (in the
    inputs' placements) and input gradients against the same call on
    plain tensors, within 1e-5 of their max."""
    got = _out(runs, "world4")["kernels"][kernel]
    assert got["placements"] == ["Shard(dim=0)", "Shard(dim=1)"]
    for name, (g, w) in got["pairs"].items():
        _close(g, w.numpy(), 1e-5, f"{kernel} {name}")


def test_serving_kernels_refuse_dtensors(runs):
    """decode attention and the LoRA merge serve one device: given a
    DTensor, each raises a TypeError that names it."""
    refused = _out(runs, "world2")["refused"]
    assert set(refused) == {"decode_attention", "lora_merge"}
    for name, msg in refused.items():
        assert msg.startswith(f"TypeError: {name}"), msg


# ---------------------------------------------------------------------------
# the elastic restart
# ---------------------------------------------------------------------------

def test_elastic_restart_restores_exactly_and_continues(runs):
    """Two steps on 4 ranks ((2, 2)), saved; restored on 2 ranks ((2, 1))
    with ``shardings=``: every leaf equal to the saved one, laid out on
    the new mesh; one more step equals one more step of a one-process run
    from the same checkpoint."""
    w4, w2 = _out(runs, "world4"), _out(runs, "world2")
    saved = topt.tree_leaves(w4["elastic_saved"])
    restored = topt.tree_leaves(w2["elastic_restored"])
    assert len(saved) == len(restored)
    for a, b in zip(saved, restored):
        assert torch.equal(a, b)
    cfg = get_arch("qwen3-1.7b").reduced(n_layers=2, vocab_size=256)
    st0 = runs["refs"]
    tmpl = ttrain.TrainState(
        params_from_jax(jax.tree.map(np.asarray, st0[3]), "cpu"), None)
    tmpl = tmpl._replace(opt=topt.init_opt_state(tmpl.params))
    # laid out by the fsdp specs on the (2, 1) mesh
    mesh = Mesh(("data", "model"), (2, 1), (torch.device("cpu"),) * 2)
    pspec = tshd.param_specs(cfg, tmpl.params, mesh, mode="fsdp")
    want = topt.tree_leaves(tshd.tree_map(
        lambda s: [repr(p) for p in tshd.placements(s, mesh)],
        ttrain.TrainState(pspec, topt.OptState(tshd.P(), pspec, pspec))))
    got = [p for pl in w2["elastic_restored_placements"] for p in pl]
    assert got == want and any(p.startswith("Shard") for p in got)
    st, extra = tck.Checkpointer(str(runs["dir"] / "ckpt")).restore(tmpl)
    ds = SyntheticLM(vocab_size=256, seq_len=16, batch_size=8, seed=2)
    ds.restore(extra["data"])
    step = ttrain.make_train_step(cfg, topt.AdamWConfig(**OPT),
                                  remat=False)
    st, m = step(st, {k: torch.from_numpy(v)
                      for k, v in ds.next_batch().items()})
    np.testing.assert_allclose(w2["elastic_loss"], float(m["loss"]),
                               rtol=LOSS_RTOL)
    for a, b in zip(topt.tree_leaves(w2["elastic_continued"]),
                    topt.tree_leaves(st)):
        _close(a, b.numpy(), TOL, "continued")


def test_sharded_checkpoint_restores_in_reference_checkpointer(runs):
    """The 4-rank run's checkpoint (gathered, written by rank 0) restores
    in the JAX package's ``Checkpointer``, every leaf equal."""
    w4 = _out(runs, "world4")
    jep = runs["refs"][3]
    tmpl = jtrain.TrainState(jep, jopt.init_opt_state(jep))
    st, extra = jck.Checkpointer(str(runs["dir"] / "ckpt")).restore(tmpl)
    assert extra["step"] == 2
    for a, b in zip(jax.tree.leaves(st), topt.tree_leaves(
            w4["elastic_saved"])):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_under_torchrun_matches_one_process(runs):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train --device
    cpu --steps 3`` trains over the (2, 1) host mesh: its printed loss,
    learning rate and norm equal the one-process run's, rank 0 alone
    prints, and its final checkpoint matches the one-process one."""
    assert runs["l2_rc"] == 0, runs["l2_log"][-4000:]
    log = runs["l2_log"]
    assert "mesh: {'data': 2, 'model': 1}" in log and "world: 2" in log
    assert log.count("done") == 1

    def step3(out):
        return re.search(r"step +3 loss \S+ lr \S+ gnorm \S+", out).group(0)
    assert step3(log) == step3(runs["launch1"])
    d = runs["dir"]
    with np.load(d / "l1" / "step_000000003" / "arrays.npz") as a, \
            np.load(d / "l2" / "step_000000003" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            _close(b[k], a[k], TOL, k)


def test_launcher_production_mesh_needs_256_ranks(runs):
    """``--production-mesh`` under 2 ranks exits with a message naming the
    256 ranks it needs and the world it has."""
    assert runs["pm_rc"] != 0
    assert "over 256 ranks; the world is 2" in runs["pm_log"]
