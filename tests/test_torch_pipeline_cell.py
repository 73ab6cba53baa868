"""``build_pipeline_cell`` (the belt's dry-run entry) against the
reference's formulas (``repro/distributed/pipeline.py:372``), and its
belt at a reduced cell against ``forward`` on the CPU (the pipeline
tests' oracle)."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.launch.mesh import pipeline_stages_for as jstages
from repro.models import transformer as JT
from repro_torch.configs.base import (ARCH_IDS, SHAPES, ShapeConfig,
                                      cell_is_applicable, get_arch)
from repro_torch.distributed.pipeline import build_pipeline_cell, stage_mesh
from repro_torch.launch.mesh import pipeline_stages_for
from repro_torch.models import transformer as T


def _reference(cfg, shape, total=256):
    """The reference's n_stages, n_data and n_micro."""
    n_stages = jstages(cfg.n_layers)
    B = shape.global_batch
    n_data = total // n_stages
    while n_data > 1 and B % n_data != 0:
        n_data //= 2
    return n_stages, n_data, max(2, min(8, B // max(1, n_data)))


def _prefill_cells():
    out = []
    for arch in ARCH_IDS:
        cfg = get_arch(arch)
        kinds = set(cfg.layer_kinds())
        if len(kinds) != 1 or cfg.mrope:
            continue            # the belt refuses hybrids and M-RoPE
        shape = SHAPES["prefill_32k"]
        if cell_is_applicable(cfg, shape)[0]:
            out.append(arch)
    return out


@pytest.mark.parametrize("arch", _prefill_cells())
def test_cell_matches_reference_formulas(arch):
    cfg, shape = get_arch(arch), SHAPES["prefill_32k"]
    fn, (params, batch) = build_pipeline_cell(cfg, shape)
    n_stages, n_data, n_micro = _reference(jget_arch(arch), shape)
    assert fn.mesh.shape == {"data": n_data, "stage": n_stages}
    assert fn.n_micro == n_micro
    inputs = "embeds" if cfg.family in ("audio", "vlm") else "tokens"
    want = ((32, 32768, cfg.d_model), torch.bfloat16) if inputs == \
        "embeds" else ((32, 32768), torch.int32)
    assert (tuple(batch[inputs].shape), batch[inputs].dtype) == want
    assert batch[inputs].device.type == "meta"
    jparams = jax.eval_shape(lambda: JT.init_params(
        jget_arch(arch), jax.random.PRNGKey(0), jnp.bfloat16))
    jn = sum(a.size for a in jax.tree.leaves(jparams))
    jbytes = sum(a.size * a.dtype.itemsize for a in jax.tree.leaves(jparams))
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        else:
            leaves.append(t)
    walk(params)
    assert sum(t.numel() for t in leaves) == jn
    assert sum(t.numel() * t.element_size() for t in leaves) == jbytes
    assert all(t.device.type == "meta" for t in leaves)


def test_seq_chunk_cell():
    cfg = get_arch("qwen3-1.7b")
    fn, _ = build_pipeline_cell(cfg, SHAPES["prefill_32k"], seq_chunk=True)
    assert fn.n_micro == max(jstages(cfg.n_layers), 8)


def test_refuses_other_kinds():
    with pytest.raises(ValueError):
        build_pipeline_cell(get_arch("qwen3-1.7b"), SHAPES["train_4k"])


@pytest.mark.parametrize("arch,seq_chunk", [("qwen3-1.7b", False),
                                            ("qwen3-1.7b", True),
                                            ("mamba2-780m", False)])
def test_belt_on_cpu_equals_forward(arch, seq_chunk):
    """The cell's belt over a stage mesh of CPU devices at a reduced
    cell: its last-token logits within 1e-4 of max |forward logit|."""
    cfg = dataclasses.replace(get_arch(arch).reduced(), n_layers=4)
    shape = ShapeConfig("prefill_small", 64, 4, "prefill")
    n = pipeline_stages_for(cfg.n_layers)
    fn, (ps, bs) = build_pipeline_cell(
        cfg, shape, seq_chunk=seq_chunk,
        mesh=stage_mesh(n, 1, devices=[torch.device("cpu")] * n))
    gen = torch.Generator().manual_seed(0)
    params = T.init_params(cfg, gen, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, tuple(bs["tokens"].shape),
                         generator=gen)
    got = fn(params, {"tokens": toks})
    want = T.forward(cfg, params, {"tokens": toks}, mode="prefill")[0]
    err = (got - want).abs().max() / want.abs().max()
    assert err <= 1e-4, float(err)
