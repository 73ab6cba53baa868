"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's ``repro/launch/dryrun.py``.

The reference sets ``XLA_FLAGS`` (512 forced host devices) when it is
imported, so everything of it runs in one subprocess: its input specs,
its cell policies under ``AbstractMesh``, the argument bytes per device
that its sharding specs give over ``jax.eval_shape`` structures (no
compile), and one reduced train cell compiled on 4 of its host devices,
whose collective bytes it parses from the HLO.  The port's side runs
here, on meta DTensors over a fake process group: nothing is allocated.
"""
import dataclasses
import json
import logging
import os
import subprocess
import sys
import warnings
from pathlib import Path

import pytest
import torch

from repro.core import analytic as janalytic
from repro_torch.configs.base import (ARCH_IDS, SHAPES, ShapeConfig,
                                      cell_is_applicable, get_arch)
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import Mesh, make_production_mesh

ROOT = Path(__file__).resolve().parents[1]
MODES = ("fsdp", "model", "replicated", "2dtp")
COLL_CELL = ("qwen3-1.7b", ShapeConfig("train_64", 64, 8, "train"))
COLL_RATIO = 2.0        # the port's collective bytes within 2x of the HLO's

_REFERENCE = r"""
import json, math
import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh, PartitionSpec as P
from repro.launch import dryrun as D
from repro.launch import rooflines as rf
from repro.configs.base import (ARCH_IDS, SHAPES, ShapeConfig,
                                cell_is_applicable, get_arch)
from repro.distributed import shardings as shd
from repro.distributed.context import use_policy
from repro.models import transformer
from repro.training.train import init_train_state

MODES = ("fsdp", "model", "replicated", "2dtp")
meshes = {"16x16": AbstractMesh((16, 16), ("data", "model")),
          "2x16x16": AbstractMesh((2, 16, 16), ("pod", "data", "model"))}
out = {"specs": {}, "policy": {}, "args": {}}

def local_bytes(tree, spec, mesh):
    leaves = jax.tree.leaves(tree)
    specs = jax.tree.leaves(spec, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(specs)
    total = 0
    for a, s in zip(leaves, specs):
        shape = list(a.shape)
        for d, e in enumerate(tuple(s)):
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            n = 1
            for ax in axes:
                n *= mesh.shape[ax]
            shape[d] = -(-shape[d] // n)
        total += math.prod(shape) * jnp.dtype(a.dtype).itemsize
    return total

for arch in ARCH_IDS:
    cfg = get_arch(arch)
    for sn, shape in SHAPES.items():
        out["specs"][f"{arch}|{sn}"] = {
            k: [list(v.shape), str(v.dtype)]
            for k, v in D.input_specs(cfg, shape).items()}
        for mn, m in meshes.items():
            for mode in MODES:
                pol = D.cell_policy(cfg, shape, m, mode)
                out["policy"][f"{arch}|{sn}|{mn}|{mode}"] = [
                    repr(pol.dp), pol.seq, pol.vocab, pol.ff,
                    pol.token_groups]
        if not cell_is_applicable(cfg, shape)[0]:
            continue
        m = meshes["16x16"]
        pol = D.cell_policy(cfg, shape, m)
        batch = D.input_specs(cfg, shape)
        bspec = shd.batch_specs(cfg, batch, m,
                                shard_seq=(shape.kind != "decode"), dp=pol.dp)
        total = local_bytes(batch, bspec, m)
        if shape.kind == "train":
            st = jax.eval_shape(lambda: init_train_state(
                cfg, jax.random.PRNGKey(0), jnp.bfloat16))
            ps = shd.param_specs(cfg, st.params, m, mode="fsdp")
            total += 3 * 0 + local_bytes(st.params, ps, m)
            total += local_bytes(st.opt.m, ps, m) + local_bytes(
                st.opt.v, ps, m) + local_bytes(st.opt.step, P(), m)
        else:
            params = jax.eval_shape(lambda: transformer.init_params(
                cfg, jax.random.PRNGKey(0), jnp.bfloat16))
            total += local_bytes(params, shd.param_specs(cfg, params, m), m)
            if shape.kind == "decode":
                cache = dict(jax.eval_shape(lambda: transformer.init_cache(
                    cfg, shape.global_batch, shape.seq_len, jnp.bfloat16)))
                cache["pos"] = jax.ShapeDtypeStruct((shape.global_batch,),
                                                    jnp.int32)
                total += local_bytes(cache, shd.cache_specs(
                    cfg, cache, m, dp=pol.dp), m)
        out["args"][f"{arch}|{sn}"] = total

cfg = get_arch("qwen3-1.7b").reduced()
shape = ShapeConfig("train_64", 64, 8, "train")
mesh = jax.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
fn, structs, _ = D.build_cell(cfg, shape, mesh, unroll=cfg.n_layers)
with use_policy(D.cell_policy(cfg, shape, mesh)):
    compiled = fn.lower(*structs).compile()
out["coll"] = rf.collective_bytes(compiled.as_text())
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REFERENCE], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(autouse=True)
def _quiet():
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_the_reference(ref, arch):
    cfg = get_arch(arch)
    for sn, shape in SHAPES.items():
        got = {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
               for k, v in D.input_specs(cfg, shape).items()}
        assert all(v.device.type == "meta"
                   for v in D.input_specs(cfg, shape).values())
        assert got == ref["specs"][f"{arch}|{sn}"], (arch, sn)


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
def test_cell_policy_equals_the_reference(ref, mesh_name):
    mesh = make_production_mesh(multi_pod=mesh_name == "2x16x16")
    for arch in ARCH_IDS:
        cfg = get_arch(arch)
        for sn, shape in SHAPES.items():
            for mode in MODES:
                pol = D.cell_policy(cfg, shape, mesh, mode)
                got = [repr(pol.dp), pol.seq, pol.vocab, pol.ff,
                       pol.token_groups]
                assert got == ref["policy"][f"{arch}|{sn}|{mesh_name}|"
                                            f"{mode}"], (arch, sn, mode)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_equal_the_reference_specs(ref, arch):
    """Each applicable cell's argument bytes per device (arithmetic over
    the specs, full depth) equal the reference's specs' over its
    ``jax.eval_shape`` structures."""
    cfg = get_arch(arch)
    mesh = make_production_mesh()
    for sn, shape in SHAPES.items():
        if not cell_is_applicable(cfg, shape)[0]:
            continue
        cell = D.build_cell(cfg, shape, mesh)
        got = sum(D.local_bytes(s, sp, mesh)
                  for s, sp in zip(cell.structs, cell.specs))
        assert got == ref["args"][f"{arch}|{sn}"], (arch, sn)


SMALL = ShapeConfig("small", 64, 8, "train")
TWO = Mesh(("data", "model"), (2, 2))


@pytest.mark.parametrize("arch,kind", [("qwen3-1.7b", "train"),
                                       ("mamba2-780m", "prefill"),
                                       ("qwen2-moe-a2.7b", "train")])
def test_reduced_cell_cost(arch, kind):
    """One dense, one SSM and one MoE reduced cell with cost on a (2, 2)
    mesh: model FLOPs equal the reference's; the two-depth extrapolation
    equals a trace at full depth (uniform stacks); no plain
    intermediate of a kernel (the plain attention's (S, S) score blocks)
    is made, and the kernels are charged."""
    base = get_arch(arch).reduced()
    full = dataclasses.replace(base, n_layers=6)
    shape = dataclasses.replace(SMALL, kind=kind, seq_len=192)
    res = D.run_cell(arch, "small", arch_cfg=full, mesh=TWO, shape=shape)
    from repro.configs.base import get_arch as jget_arch
    jfull = dataclasses.replace(jget_arch(arch).reduced(), n_layers=6)
    assert res["cost"]["model_flops_total"] == janalytic.model_flops(
        jfull, shape.global_batch, shape.seq_len, kind)

    scores = []     # (queries, keys) blocks: the plain attention's
    count = D._Counter._count
    S = shape.seq_len

    def spy(self, func, args, kwargs, flat, out):
        for o in (out if isinstance(out, (list, tuple)) else [out]):
            if isinstance(o, torch.Tensor) and o.dim() >= 2 \
                    and o.shape[-1] == S and o.shape[-2] in (S, S // 2):
                scores.append(tuple(o.shape))
        return count(self, func, args, kwargs, flat, out)

    D._Counter._count = spy
    try:
        with D.fake_mesh(TWO) as dm:
            tr = D.trace_cell(D.build_cell(full, shape, TWO), TWO,
                              D.cell_policy(full, shape, TWO), dm)
    finally:
        D._Counter._count = count
    t = tr.totals
    c = res["cost"]
    assert c["hlo_flops_per_device"] == pytest.approx(t.flops, rel=1e-9)
    assert c["hlo_bytes_per_device"] == pytest.approx(t.bytes, rel=1e-9)
    assert c["coll_bytes_per_device"] == pytest.approx(
        sum(t.coll.values()), rel=1e-9)
    assert t.kernels["flash_attention" if arch != "mamba2-780m"
                     else "ssd_scan"] > 0
    assert not scores, scores


def test_collective_bytes_against_the_reference_hlo(ref):
    """The reduced train cell's collective bytes, the port's trace against
    the reference's HLO (its layer loop unrolled, as its cost points
    are), within a factor of 2: the two partitioners (DTensor's
    per-op propagation, XLA's SPMD pass) choose different
    redistributions for the same specs."""
    arch, shape = COLL_CELL
    cfg = get_arch(arch).reduced()
    with D.fake_mesh(TWO) as dm:
        tr = D.trace_cell(D.build_cell(cfg, shape, TWO), TWO,
                          D.cell_policy(cfg, shape, TWO), dm)
    got, want = tr.totals.coll, ref["coll"]
    print("port", {k: int(v) for k, v in got.items()})
    print("reference HLO", want)
    g, w = sum(got.values()), sum(want.values())
    assert w > 0 and 1 / COLL_RATIO <= g / w <= COLL_RATIO, (g, w)


def test_skip_cost_sweep_cli_allocates_nothing(tmp_path):
    """``--skip-cost`` over one cell through the CLI: the [OK] line, the
    result file, and no tensor left on any device."""
    rc = D.main(["--arch", "mamba2-780m", "--shape", "decode_32k",
                 "--skip-cost", "--out", str(tmp_path)])
    assert rc == 0
    res = json.loads((tmp_path / "mamba2-780m__decode_32k__singlepod.json")
                     .read_text())
    assert res["memory"]["argument_bytes"] > 0 and "cost" not in res
    assert not torch.distributed.is_initialized()


def test_pipeline_cell_cost():
    res = D.run_cell("qwen3-1.7b", "prefill_32k", pipeline_mode=True)
    p = res["cost"]["pipeline"]
    assert (p["n_stages"], p["n_micro"], p["n_ticks"]) == (4, 2, 5)
    assert res["mesh"] == "32x4"
    assert res["cost"]["coll_bytes_per_device"] > 0
