"""The port's pipeline prefill belt (``repro_torch.distributed.pipeline``)
and its wiring into the engine, the batcher, the cluster server and the
launcher, against the reference.

The oracle: one subprocess with 8 forced XLA host devices (as
``tests/test_distributed.py`` runs its multi-device checks) runs the
reference's ``build_pipeline_prefill(return_cache=True)`` on ('data',
'stage') meshes (1, 4) and (2, 4) for reduced qwen3-1.7b (with and without
``last_index``), mamba2-780m, pipeboost-opt-1.3b and qwen2-moe-a2.7b (from
tokens and from embeddings, and with a capacity factor of 0.5 that drops
tokens in each microbatch's routing), and the reference's sequence-chunk
belt (4 stages, 8 chunks; also qwen2-vl-72b with its t = h = w M-RoPE
stub), and saves its params and outputs
as numpy arrays (the reference's ``init_params`` folds ``hash(kind)`` into
its key, so the params must travel with the outputs).  The port's belts on
``stage_mesh(..., devices=[cpu] * 8)`` hold its logits and every cache leaf
to 1e-4: float32 on both sides, the two differ only in sum order.

The wiring tests patch ``visible_devices`` to 8 CPU devices, where the
reference's engine would find 8 XLA devices, and hold the streams of the
belt's engine and batcher equal to the single prefill's and to the
reference's single-lowering engine's (the equality the reference's own
``test_pipeline_prefill_wiring_multi_device`` asserts).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.core import engine as jeng
from repro.models import transformer as JT
from repro_torch.cluster.router import ClusterConfig, ClusterServer
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core import engine as teng
from repro_torch.distributed import pipeline as P
from repro_torch.launch import serve as tlaunch
from repro_torch.models import transformer as T
from test_torch_stable_init import stable_init
from repro_torch.serving.engine import (ServeRequest, ServingEngine,
                                        quantized_greedy)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
# case -> (arch, reduced-config overrides, GPipe belt, sequence-chunk belt)
CASES = {
    "qwen3-1.7b": ("qwen3-1.7b", {}, True, True),
    "mamba2-780m": ("mamba2-780m", {}, True, False),
    "pipeboost-opt-1.3b": ("pipeboost-opt-1.3b", {}, True, True),
    "qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", {}, True, True),
    "qwen2-moe-cf0.5": ("qwen2-moe-a2.7b", {"capacity_factor": 0.5}, True,
                        True),
    "qwen2-vl-72b": ("qwen2-vl-72b", {}, False, True),
}
# the GPipe belt's runs of a case: "" tokens, "_last" with last_index,
# "_embeds" from embeddings
GPIPE_TAGS = {"qwen3-1.7b": ("", "_last"), "qwen2-moe-a2.7b": ("", "_embeds")}
CPU8 = [torch.device("cpu")] * 8
B, S, MAX_LEN = 4, 32, 64
LAST = np.array([31, 20, 5, 17], np.int32)

_ORACLE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import get_arch
    from repro.distributed.pipeline import (build_pipeline_prefill,
                                            build_pipeline_prefill_seqchunk,
                                            stage_mesh)
    from repro.models import transformer as T
    sys.path.insert(0, "tests")
    from test_torch_stable_init import stable_init

    B, S, MAX_LEN = %d, %d, %d
    out = {}

    def put(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[prefix + "/".join(p.key for p in path)] = np.asarray(leaf)

    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    embeds = rng.standard_normal((B, S, 64)).astype(np.float32)
    last = np.array(%r, np.int32)
    out["tokens"], out["embeds"] = toks, embeds
    inputs = {"": {"tokens": jnp.asarray(toks)},
              "_last": {"tokens": jnp.asarray(toks),
                        "last_index": jnp.asarray(last)},
              "_embeds": {"embeds": jnp.asarray(embeds)}}
    tags = %r
    for name, (arch, over, gpipe, seqchunk) in %r.items():
        cfg = get_arch(arch).reduced(n_layers=4, vocab_size=256, **over)
        with stable_init():
            params = T.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
        put(name + "/params/", params)
        for nd in (1, 2):
            mesh = stage_mesh(4, nd)
            if gpipe:
                f = build_pipeline_prefill(cfg, n_stages=4, n_micro=2,
                                           mesh=mesh, seq_len=S,
                                           max_len=MAX_LEN,
                                           return_cache=True)
                for tag in tags.get(name, ("",)):
                    lg, st = f(params, inputs[tag])
                    out[f"{name}/gpipe{nd}{tag}/logits"] = np.asarray(lg)
                    put(f"{name}/gpipe{nd}{tag}/cache/", st)
            if seqchunk:
                f2 = build_pipeline_prefill_seqchunk(
                    cfg, n_stages=4, n_chunks=8, mesh=mesh, seq_len=S)
                out[f"{name}/seqchunk{nd}/logits"] = np.asarray(
                    f2(params, inputs[""]))
    np.savez(sys.argv[1], **out)
    print("ORACLE_OK")
""" % (B, S, MAX_LEN, LAST.tolist(), GPIPE_TAGS, CASES))


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    path = tmp_path_factory.mktemp("pipeline_oracle") / "oracle.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _ORACLE, str(path)], env=env,
                       capture_output=True, text=True, timeout=600,
                       cwd=str(ROOT))
    assert r.returncode == 0 and "ORACLE_OK" in r.stdout, r.stderr[-3000:]
    with np.load(path) as z:
        return dict(z)


def _nest(flat, prefix):
    """{prefix + "a/b/c": arr} -> {"a": {"b": {"c": arr}}}."""
    tree = {}
    for key, arr in flat.items():
        if not key.startswith(prefix):
            continue
        *parts, leaf = key[len(prefix):].split("/")
        node = tree
        for p in parts:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def _cfg(name):
    arch, over = CASES.get(name, (name, {}))[:2]
    return get_arch(arch).reduced(n_layers=4, vocab_size=256, **over)


def _oracle_batch(oracle, tag):
    if tag == "_embeds":
        return {"embeds": torch.from_numpy(oracle["embeds"])}
    batch = {"tokens": torch.from_numpy(oracle["tokens"].astype(np.int64))}
    if tag == "_last":
        batch["last_index"] = torch.from_numpy(LAST)
    return batch


def _assert_cache_close(got, want, tol=TOL):
    """Every state leaf of ``want`` (kind -> leaf), shapes and dtypes
    equal, values within ``tol``."""
    for kind, leaves in want.items():
        for leaf, w in leaves.items():
            g = got[kind][leaf]
            w = torch.as_tensor(np.asarray(w))
            assert g.shape == w.shape and g.dtype == w.dtype, (kind, leaf)
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=tol,
                                       err_msg=f"{kind}/{leaf}")


@pytest.mark.parametrize("arch,nd,tag", [
    (a, nd, tag) for a, case in CASES.items() if case[2] for nd in (1, 2)
    for tag in GPIPE_TAGS.get(a, ("",))])
def test_gpipe_belt_matches_jax_belt(oracle, arch, nd, tag):
    """The port's belt (4 stages, 2 microbatches) on the reference's
    params: logits and every cache leaf within 1e-4 of the reference's
    belt on the same ('data', 'stage') mesh shape; ``pos`` at
    ``last_index + 1`` or S.  An MoE belt routes each microbatch alone,
    with its own capacity, as the reference's does."""
    cfg = _cfg(arch)
    params = params_from_jax(_nest(oracle, f"{arch}/params/"), "cpu")
    batch = _oracle_batch(oracle, tag)
    f = P.build_pipeline_prefill(cfg, n_stages=4, n_micro=2,
                                 mesh=P.stage_mesh(4, nd, devices=CPU8),
                                 seq_len=S, max_len=MAX_LEN,
                                 return_cache=True)
    logits, cache = f(params, batch)
    run = f"{arch}/gpipe{nd}{tag}"
    np.testing.assert_allclose(logits.numpy(), oracle[f"{run}/logits"],
                               atol=TOL)
    _assert_cache_close(cache, _nest(oracle, f"{run}/cache/"))
    want_pos = LAST + 1 if tag == "_last" else np.full((B,), S, np.int32)
    np.testing.assert_array_equal(cache["pos"].numpy(), want_pos)


@pytest.mark.parametrize("arch,nd", [
    (a, nd) for a, case in CASES.items() if case[3] for nd in (1, 2)])
def test_seqchunk_belt_matches_jax_belt(oracle, arch, nd):
    """The sequence-chunk belt (4 stages, 8 chunks of 4 tokens) against
    the reference's on the same mesh shape (an MoE layer routes each
    chunk alone; an M-RoPE model takes t = h = w positions)."""
    cfg = _cfg(arch)
    params = params_from_jax(_nest(oracle, f"{arch}/params/"), "cpu")
    f = P.build_pipeline_prefill_seqchunk(
        cfg, n_stages=4, n_chunks=8, mesh=P.stage_mesh(4, nd, devices=CPU8),
        seq_len=S)
    logits = f(params, {"tokens": torch.from_numpy(
        oracle["tokens"].astype(np.int64))})
    np.testing.assert_allclose(logits.numpy(),
                               oracle[f"{arch}/seqchunk{nd}/logits"],
                               atol=TOL)


def _torch_setup(cfg, seed=0):
    params = T.init_params(cfg, torch.Generator().manual_seed(seed),
                           device="cpu")
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)))
    return params, toks


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-780m"])
@pytest.mark.parametrize("n_stages,n_micro,n_data", [
    (s, m, d) for s in (2, 4) for m in (1, 2) for d in (1, 2)])
def test_belt_matches_forward(arch, n_stages, n_micro, n_data):
    """The belt against the port's own ``forward(mode="prefill")``: the
    same logits and cache (keys, shapes, dtypes, values within 1e-4,
    ``pos``) for every split of the 4 rows over data rows and
    microbatches."""
    cfg = _cfg(arch)
    params, toks = _torch_setup(cfg)
    want_logits, want = T.forward(cfg, params, {"tokens": toks},
                                  mode="prefill", max_len=MAX_LEN)
    f = P.build_pipeline_prefill(
        cfg, n_stages=n_stages, n_micro=n_micro,
        mesh=P.stage_mesh(n_stages, n_data, devices=CPU8), seq_len=S,
        max_len=MAX_LEN, return_cache=True)
    logits, cache = f(params, {"tokens": toks})
    np.testing.assert_allclose(logits.numpy(), want_logits.numpy(),
                               atol=TOL)
    assert set(cache) == set(want)
    _assert_cache_close(cache, {k: v for k, v in want.items()
                                if k != "pos"})
    assert torch.equal(cache["pos"], want["pos"])
    # without the cache: the logits alone
    f2 = P.build_pipeline_prefill(
        cfg, n_stages=n_stages, n_micro=n_micro,
        mesh=P.stage_mesh(n_stages, n_data, devices=CPU8), seq_len=S)
    np.testing.assert_allclose(f2(params, {"tokens": toks}).numpy(),
                               want_logits.numpy(), atol=TOL)


def test_belt_ring_window_matches_forward():
    """A windowed model (window 16 < prompt 32): each stage rolls its
    layers' K/V into the ring exactly as ``forward`` does."""
    cfg = dataclasses.replace(_cfg("qwen3-1.7b"), attn_window=16)
    params, toks = _torch_setup(cfg, seed=1)
    want_logits, want = T.forward(cfg, params, {"tokens": toks},
                                  mode="prefill", max_len=MAX_LEN)
    f = P.build_pipeline_prefill(cfg, n_stages=4, n_micro=2,
                                 mesh=P.stage_mesh(4, 1, devices=CPU8),
                                 seq_len=S, max_len=MAX_LEN,
                                 return_cache=True)
    logits, cache = f(params, {"tokens": toks})
    assert cache["attn"]["k"].shape[2] == 16
    np.testing.assert_allclose(logits.numpy(), want_logits.numpy(),
                               atol=TOL)
    _assert_cache_close(cache, {"attn": want["attn"]})


@pytest.mark.parametrize("cf,equal", [(2.0, True), (0.5, False)])
def test_moe_belt_routes_per_microbatch(cf, equal):
    """An MoE belt equals ``forward`` where no capacity can bind (factor
    E/K = 2: every expert has a slot for every token) and differs from it
    where capacity binds: each microbatch routes alone with its own
    capacity, as the reference's belt does, while ``forward`` routes the
    whole batch."""
    cfg = dataclasses.replace(_cfg("qwen2-moe-a2.7b"), capacity_factor=cf)
    params, toks = _torch_setup(cfg, seed=3)
    want, _ = T.forward(cfg, params, {"tokens": toks}, mode="prefill",
                        max_len=MAX_LEN)
    f = P.build_pipeline_prefill(cfg, n_stages=4, n_micro=2,
                                 mesh=P.stage_mesh(4, 1, devices=CPU8),
                                 seq_len=S, max_len=MAX_LEN,
                                 return_cache=True)
    got, _ = f(params, {"tokens": toks})
    err = (got - want).abs().max().item()
    assert err <= TOL if equal else err > 1e-3


def test_gpipe_belt_refuses_mrope():
    """The GPipe belt has no (t, h, w) position stream for M-RoPE (the
    reference's belt fails on it); the sequence-chunk belt takes the
    t = h = w stub."""
    cfg = _cfg("qwen2-vl-72b")
    mesh = P.stage_mesh(4, 1, devices=CPU8)
    with pytest.raises(ValueError, match="M-RoPE"):
        P.build_pipeline_prefill(cfg, n_stages=4, n_micro=1, mesh=mesh,
                                 seq_len=S)
    params, toks = _torch_setup(cfg, seed=4)
    pos = torch.arange(S)[None, :, None].expand(B, S, 3)
    want, _ = T.forward(cfg, params, {"tokens": toks, "positions": pos},
                        mode="prefill")
    f = P.build_pipeline_prefill_seqchunk(cfg, n_stages=4, n_chunks=8,
                                          mesh=mesh, seq_len=S)
    np.testing.assert_allclose(f(params, {"tokens": toks}).numpy(),
                               want.numpy(), atol=TOL)


@pytest.mark.parametrize("n_stages,n_chunks,n_data", [
    (2, 4, 1), (4, 8, 2), (4, 32, 1)])
def test_seqchunk_matches_forward(n_stages, n_chunks, n_data):
    cfg = _cfg("pipeboost-opt-1.3b")
    params, toks = _torch_setup(cfg, seed=2)
    want, _ = T.forward(cfg, params, {"tokens": toks}, mode="prefill")
    f = P.build_pipeline_prefill_seqchunk(
        cfg, n_stages=n_stages, n_chunks=n_chunks,
        mesh=P.stage_mesh(n_stages, n_data, devices=CPU8), seq_len=S)
    np.testing.assert_allclose(f(params, {"tokens": toks}).numpy(),
                               want.numpy(), atol=TOL)


def test_belts_refuse_what_they_cannot_run():
    """Hybrids (both belts), an SSM for the sequence-chunk belt, and
    shapes that do not split over the grid raise; ``stage_mesh`` refuses a
    grid larger than its pool."""
    hy = get_arch("recurrentgemma-2b").reduced(n_layers=6)
    mesh = P.stage_mesh(2, 1, devices=CPU8)
    with pytest.raises(ValueError, match="uniform"):
        P.build_pipeline_prefill(hy, n_stages=2, n_micro=1, mesh=mesh,
                                 seq_len=S)
    with pytest.raises(ValueError, match="KV"):
        P.build_pipeline_prefill_seqchunk(_cfg("mamba2-780m"), n_stages=2,
                                          n_chunks=4, mesh=mesh, seq_len=S)
    cfg = _cfg("qwen3-1.7b")
    params, toks = _torch_setup(cfg)
    f = P.build_pipeline_prefill(cfg, n_stages=2, n_micro=3, mesh=mesh,
                                 seq_len=S)
    with pytest.raises(ValueError, match="split"):
        f(params, {"tokens": toks})
    with pytest.raises(ValueError, match="needs 9"):
        P.stage_mesh(3, 3, devices=CPU8)
    assert P.stage_mesh(3, devices=CPU8).shape == {"data": 2, "stage": 3}
    assert all(d.type == "cuda" for d in P.visible_devices())


# ---------------------------------------------------------------------------
# the wiring (ported from tests/test_coldstart.py::_PIPE)
# ---------------------------------------------------------------------------

@pytest.fixture
def eight_devices(monkeypatch):
    """The engine sees 8 devices (CPU), as the reference's subprocess sees
    8 forced XLA host devices."""
    monkeypatch.setattr(P, "visible_devices", lambda: list(CPU8))


def test_enable_pipeline_prefill_gates(eight_devices, monkeypatch):
    """Refused on one visible device, for a hybrid stack and for a layer
    count no stage count divides; an explicit grid enables it."""
    cfg = _cfg("qwen3-1.7b")
    params, _ = _torch_setup(cfg)
    eng = teng.PipeBoostEngine(cfg, params, n_devices=4, max_len=MAX_LEN)
    assert eng.enable_pipeline_prefill()
    assert eng._pipe_mesh.shape == {"data": 2, "stage": 4}
    monkeypatch.setattr(P, "visible_devices", lambda: list(CPU8[:1]))
    assert not teng.PipeBoostEngine(cfg, params, n_devices=4).\
        enable_pipeline_prefill()
    monkeypatch.setattr(P, "visible_devices", lambda: list(CPU8))
    hy = get_arch("recurrentgemma-2b").reduced(n_layers=6)
    ehy = teng.PipeBoostEngine(hy, T.init_params(
        hy, torch.Generator().manual_seed(0), device="cpu"), n_devices=2)
    assert not ehy.enable_pipeline_prefill()
    odd = dataclasses.replace(cfg, n_layers=3)     # 3 stages, 8 devices
    eodd = teng.PipeBoostEngine(odd, T.init_params(
        odd, torch.Generator().manual_seed(0), device="cpu"), n_devices=2)
    assert not eodd.enable_pipeline_prefill()
    assert not eodd.enable_pipeline_prefill(
        mesh=P.stage_mesh(2, 1, devices=CPU8))
    assert eodd.enable_pipeline_prefill(mesh=P.stage_mesh(3, 1,
                                                          devices=CPU8))
    # the refusal leaves the single prefill working
    e1 = teng.PipeBoostEngine(cfg, params, n_devices=4, max_len=MAX_LEN)
    monkeypatch.setattr(P, "visible_devices", lambda: [])
    assert not e1.enable_pipeline_prefill()
    e1.load_round()
    e1.prefill({"tokens": torch.zeros((B, S), dtype=torch.int64)})
    assert e1.prefill_backend_used == "single"
    assert e1.compile_stats()["pipeline_prefill_compiles"] == 0


def _jax_pair(arch):
    jcfg = jget_arch(arch).reduced(n_layers=4, vocab_size=256)
    with stable_init():
        jparams = JT.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, _cfg(arch), tparams


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-780m"])
def test_engine_pipeline_prefill_streams(eight_devices, arch):
    """A mid-load engine prefills through the belt; its stream equals a
    fully loaded single engine's and the reference's single-lowering
    engine's.  After the fill and the strategy switch decode goes on over
    the belt's cache, and a later prefill runs single."""
    jcfg, jparams, cfg, params = _jax_pair(arch)
    toks = np.random.default_rng(1).integers(0, 256, (B, S))
    batch = {"tokens": torch.from_numpy(toks)}
    e1 = teng.PipeBoostEngine(cfg, params, n_devices=4, max_len=MAX_LEN)
    assert e1.enable_pipeline_prefill()
    e1.load_round()
    assert e1.ready and not e1.fully_loaded
    toks1 = teng.generate(e1, batch, 8)
    assert e1.prefill_backend_used == "pipeline"
    assert ("prefill_backend", "pipeline") in e1.events
    e2 = teng.PipeBoostEngine(cfg, params, n_devices=4, max_len=MAX_LEN)
    while e2.load_round():
        pass
    e2.maybe_switch_strategy(1.0)
    toks2 = teng.generate(e2, batch, 8)
    assert e2.prefill_backend_used == "single"
    np.testing.assert_array_equal(toks1.numpy(), toks2.numpy())
    je = jeng.PipeBoostEngine(jcfg, jparams, n_devices=4, max_len=MAX_LEN)
    je.load_round()
    jt = jeng.generate(je, {"tokens": jnp.asarray(toks, jnp.int32)}, 8)
    np.testing.assert_array_equal(toks1.numpy(), np.asarray(jt))
    # the belt's cache has the single prefill's layout
    single = {k: v for k, v in e2._cache.items() if k != "pos"}
    for kind, leaves in single.items():
        for leaf, t in leaves.items():
            assert e1._cache[kind][leaf].shape == t.shape
            assert e1._cache[kind][leaf].dtype == t.dtype
    # strategy switch mid-decode
    while e1.load_round():
        pass
    assert e1.maybe_switch_strategy(request_rate=1.0)
    e1.decode(toks1[:, -1])
    e1.prefill(batch)
    assert e1.prefill_backend_used == "single"
    e1.decode(toks1[:, -1])
    cs = e1.compile_stats()
    assert cs == {"decode_compiles": 0, "prefill_compiles": 1,
                  "pipeline_prefill_compiles": 1}


def test_engine_pipeline_with_adapter(eight_devices):
    """The belt runs the engine's merged params: with an adapter switched
    on, the mid-load stream equals a fully loaded engine's with the same
    adapter."""
    from repro_torch.lora.adapters import init_lora, randomize_lora
    cfg = _cfg("qwen3-1.7b")
    params, toks = _torch_setup(cfg, seed=3)
    g = torch.Generator().manual_seed(4)
    ads = {f"lora{i}": randomize_lora(g, init_lora(
        g, cfg, rank=4, name=f"lora{i}", device="cpu")) for i in range(2)}
    streams = []
    for pipelined in (True, False):
        e = teng.PipeBoostEngine(cfg, params, n_devices=4, max_len=MAX_LEN,
                                 adapters=ads)
        if pipelined:
            assert e.enable_pipeline_prefill()
            e.load_round()
        else:
            while e.load_round():
                pass
            e.maybe_switch_strategy(1.0)
        e.switch_adapter("lora1")
        streams.append(teng.generate(e, {"tokens": toks}, 6))
        assert e.prefill_backend_used == ("pipeline" if pipelined
                                          else "single")
    np.testing.assert_array_equal(streams[0].numpy(), streams[1].numpy())


def _serve(cfg, params, prompts, eng=None):
    """4 prompts, then (after the engine's fill and switch) 4 more."""
    srv = ServingEngine(cfg, params, n_slots=4, max_len=128)
    srv.batcher.sampler = quantized_greedy
    if eng is not None:
        eng.wire_pipeline_prefill(srv.batcher)
    for i, p in enumerate(prompts[:4]):
        srv.submit(ServeRequest(i, p, max_new_tokens=4))
    srv.run()
    n_pipe = srv.batcher.n_prefill_pipeline
    if eng is not None:
        assert n_pipe >= 4, n_pipe
        while eng.load_round():
            pass
        assert eng.maybe_switch_strategy(request_rate=1.0)
    for i, p in enumerate(prompts[4:]):
        srv.submit(ServeRequest(10 + i, p, max_new_tokens=4))
    srv.run()
    # post-switch admissions took the single prefill
    assert srv.batcher.n_prefill_pipeline == n_pipe
    assert srv.hotpath_stats()["n_prefill_pipeline"] == n_pipe
    return sorted((r.rid, tuple(r.generated)) for r in srv.completed)


def test_batcher_pipeline_dispatch(eight_devices):
    """Admissions mid-load run the engine's belt (bucketed rows with
    ``last_index``, written through the batcher's scatter), admissions
    after the switch the single prefill; the streams equal an unwired
    server's."""
    cfg = _cfg("qwen3-1.7b")
    params, _ = _torch_setup(cfg)
    eng = teng.PipeBoostEngine(cfg, params, n_devices=4, max_len=128)
    assert eng.enable_pipeline_prefill(n_micro=1)
    eng.load_round()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, size=12 + i) for i in range(8)]
    out_pipe = _serve(cfg, params, prompts, eng)
    out_single = _serve(cfg, params, prompts)
    assert out_pipe == out_single
    assert eng.compile_stats()["pipeline_prefill_compiles"] >= 1


def test_cluster_server_wires_its_batcher(eight_devices):
    """A ``ClusterServer`` on a host with several devices wires its
    batcher to its engine's belt: its mid-load admissions run the belt and
    give the stream of a server on one device."""
    cfg = _cfg("qwen3-1.7b")
    params, _ = _torch_setup(cfg)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, size=20) for _ in range(4)]
    ccfg = ClusterConfig(n_devices=2, n_slots=4, max_len=MAX_LEN)

    def run(server):
        server.engine.load_round()
        reqs = [ServeRequest(i, p, max_new_tokens=5)
                for i, p in enumerate(prompts)]
        for r in reqs:
            server.srv.submit(r)
        server.srv.run()
        return [r.generated for r in reqs]

    wired = ClusterServer(0, cfg, params, ccfg)
    assert wired.srv.batcher._pipe_prefill is not None
    got = run(wired)
    assert wired.srv.batcher.n_prefill_pipeline == 4
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(P, "visible_devices", lambda: [])
        plain = ClusterServer(1, cfg, params, ccfg)
    assert plain.srv.batcher._pipe_prefill is None
    assert run(plain) == got


def test_repartition_resplits_the_belt(eight_devices):
    """4 layers on a pool of 8 devices: a repartition to 3 alive devices
    re-splits the belt into 2 stages (3 does not divide 4), the next
    prefill runs the 2-stage belt, and the stream is unchanged."""
    cfg = _cfg("qwen3-1.7b")
    params, toks = _torch_setup(cfg, seed=6)
    ref = teng.PipeBoostEngine(cfg, params, n_devices=4, max_len=MAX_LEN)
    ref.load_round()
    want = teng.generate(ref, {"tokens": toks}, 6)
    eng = teng.PipeBoostEngine(cfg, params, n_devices=4, max_len=MAX_LEN)
    assert eng.enable_pipeline_prefill(n_micro=1)
    eng.load_round()
    got = teng.generate(eng, {"tokens": toks}, 6)
    assert eng._pipe_n_stages == 4
    stats = eng.repartition(dead=[3])
    assert stats["n_stages"] == 2
    assert eng._pipe_mesh.shape == {"data": 4, "stage": 2}
    got2 = teng.generate(eng, {"tokens": toks}, 6)
    assert eng.prefill_backend_used == "pipeline"
    assert set(eng._pipe_fns) == {(4, B, S), (2, B, S)}
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got2.numpy(), want.numpy())
    # no belt requested: 0 stages, as the reference reports
    plain = teng.PipeBoostEngine(cfg, params, n_devices=4, max_len=MAX_LEN)
    plain.load_round()
    assert plain.repartition(dead=[3])["n_stages"] == 0


def test_launcher_wires_the_belt(eight_devices, capsys):
    """``launch.serve`` on a host with several devices: admissions run
    the belt and the streams equal a one-device run's."""
    argv = ["--device", "cpu", "--requests", "4", "--adapters", "0",
            "--new-tokens", "4", "--max-len", "96", "--prompt-len", "8-24"]
    wired = tlaunch.main(argv)
    assert wired.hotpath["n_prefill_pipeline"] == 4
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(P, "visible_devices", lambda: [])
        plain = tlaunch.main(argv)
    assert plain.hotpath["n_prefill_pipeline"] == 0
    assert [r.generated for r in wired.requests] == \
        [r.generated for r in plain.requests]
