"""The port's crash migration and in-flight rebuild against the JAX package:
KV snapshots (``serving/snapshot.py``), the batcher's drain / import /
batched import / reconstruct / re-lay, and the serving engine's guards.

Reduced configs in float32 (and bf16 for the wire format), weights from the
reference converted with ``params_from_jax``, prompts from numpy.  Token
streams under ``quantized_greedy`` must equal the reference's solo run.
The graph contract is checked on the CPU as far as it can be: no cache
leaf, step buffer or parameter tensor is ever rebound.
"""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.lora import adapters as jlora
from repro.models import transformer as JT
from repro.serving import engine as jserve
from repro.serving.snapshot import KVSnapshot as JSnapshot
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_jax, to_numpy
from repro_torch.core.kv_reconstruct import _kind_indices
from repro_torch.lora import adapters as tlora
from repro_torch.serving import engine as tserve
from repro_torch.serving.snapshot import KVSnapshot, dtype_name

KEY = jax.random.PRNGKey(11)

CASES = [
    ("qwen3-1.7b", {}),                          # dense, full-length cache
    ("qwen3-1.7b", {"attn_window": 8}),          # pure-attention ring
    ("recurrentgemma-2b", {"attn_window": 8}),   # hybrid rec + ring
    ("mamba2-780m", {}),                         # SSM state only
]


@functools.lru_cache(maxsize=None)
def _setup(arch, layers=4, window=None, dtype=None):
    kw = {} if window is None else {"attn_window": window}
    if dtype is not None:
        kw["dtype"] = dtype
    jcfg = jget_arch(arch).reduced(n_layers=layers, **kw)
    tcfg = get_arch(arch).reduced(n_layers=layers, **kw)
    jparams = JT.init_params(jcfg, KEY)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _case(arch, kw):
    return _setup(arch, 4, kw.get("attn_window"))


@functools.lru_cache(maxsize=None)
def _jitted(jcfg, max_len):
    prefill = jax.jit(lambda p, t: JT.forward(
        jcfg, p, {"tokens": t}, mode="prefill", max_len=max_len))
    step = jax.jit(lambda p, t, c: JT.decode_step(jcfg, p, {"tokens": t}, c))
    return prefill, step


def _solo(jcfg, jparams, prompt, n, max_len=96):
    """The reference's uninterrupted single-request greedy stream."""
    prefill, step = _jitted(jcfg, max_len)
    lg, cache = prefill(jparams, jnp.asarray(prompt)[None])
    toks = [int(jserve.quantized_greedy(lg)[0])]
    for _ in range(n - 1):
        lg, cache = step(jparams, jnp.asarray([toks[-1]], jnp.int32), cache)
        toks.append(int(jserve.quantized_greedy(lg)[0]))
    return toks


def _engine(cfg, params, n_slots=2, max_len=96, adapter_params=None):
    e = tserve.ServingEngine(cfg, params, n_slots=n_slots, max_len=max_len,
                             adapter_params=adapter_params)
    e.batcher.sampler = tserve.quantized_greedy
    return e


def _jengine(cfg, params, n_slots=2, max_len=96):
    e = jserve.ServingEngine(cfg, params, n_slots=n_slots, max_len=max_len)
    e.batcher.sampler = jserve.quantized_greedy
    return e


def _finish(e):
    while e.batcher.n_active:
        e.step()


def _storage(b):
    """Addresses of everything a captured decode step reads."""
    ptrs = [b._dev_tokens.data_ptr(), b._dev_active.data_ptr(),
            b.cache["pos"].data_ptr()]
    for kind in ("attn", "ssm", "rec"):
        for a in b.cache.get(kind, {}).values():
            ptrs.append(a.data_ptr())
    ptrs += [t.data_ptr() for _, t in tserve._leaves(b.params)]
    return ptrs


@pytest.mark.parametrize("arch,kw", CASES,
                         ids=[f"{a}{'-ring' if k else ''}" for a, k in CASES])
def test_migration_roundtrip_matches_solo(arch, kw):
    """Drain mid-decode, import on a fresh engine: the reference's solo
    tokens, with zero prefill on the survivor (ring cases: a prompt longer
    than the window, so the wrapped ring rides through the snapshot)."""
    jcfg, jparams, tcfg, tparams = _case(arch, kw)
    prompt = np.random.default_rng(0).integers(0, 250, size=20)
    a = _engine(tcfg, tparams)
    req = tserve.ServeRequest(0, prompt, max_new_tokens=10)
    a.submit(req)
    for _ in range(4):
        a.step()
    assert a.drain_inflight() == [req]
    assert req.snapshot is not None and 1 < len(req.generated) < 10
    n_state = len(prompt) + len(req.generated) - 1
    assert req.snapshot.pos == n_state
    b = _engine(tcfg, tparams)
    ptrs = _storage(b.batcher)
    assert b.admit_with_state(req)
    assert req.snapshot is None
    assert b.batcher.n_migrated_in == 1
    assert b.batcher.migrated_tokens_in == n_state
    _finish(b)
    assert req.done
    assert req.generated == _solo(jcfg, jparams, prompt, 10)
    assert b.batcher.n_prefill_reqs == 0 and b.batcher.n_prefill_tokens == 0
    assert _storage(b.batcher) == ptrs


def _to_port(js: JSnapshot) -> KVSnapshot:
    return KVSnapshot(js.arch, js.max_len, js.pos, rows=js.rows)


def _to_reference(ts: KVSnapshot) -> JSnapshot:
    rows = {kind: {leaf: (a.view(ml_dtypes.bfloat16)
                          if ts.leaf_dtype(kind, leaf) == "bfloat16" else a)
                   for leaf, a in leaves.items()}
            for kind, leaves in ts.rows.items()}
    return JSnapshot(ts.arch, ts.max_len, ts.pos, rows=rows)


@pytest.mark.parametrize("arch,kw", [CASES[0], CASES[2], CASES[3]],
                         ids=["qwen3", "recurrentgemma-ring", "mamba2"])
def test_snapshot_crosses_packages(arch, kw):
    """A snapshot exported by a JAX server resumes in a port server, and one
    exported by a port server resumes in a JAX server; both continue with
    the reference's solo tokens."""
    jcfg, jparams, tcfg, tparams = _case(arch, kw)
    rng = np.random.default_rng(1)
    p1, p2 = rng.integers(0, 250, size=17), rng.integers(0, 250, size=12)
    ja = _jengine(jcfg, jparams)
    r1 = jserve.ServeRequest(0, p1, max_new_tokens=9)
    ja.submit(r1)
    for _ in range(3):
        ja.step()
    [r1] = ja.drain_inflight()
    t1 = tserve.ServeRequest(0, p1, max_new_tokens=9,
                             generated=[int(t) for t in r1.generated],
                             snapshot=_to_port(r1.snapshot))
    tb = _engine(tcfg, tparams)
    assert tb.admit_with_state(t1)
    _finish(tb)
    assert t1.generated == _solo(jcfg, jparams, p1, 9)

    ta = _engine(tcfg, tparams)
    r2 = tserve.ServeRequest(1, p2, max_new_tokens=9)
    ta.submit(r2)
    for _ in range(3):
        ta.step()
    [r2] = ta.drain_inflight()
    j2 = jserve.ServeRequest(1, p2, max_new_tokens=9,
                             generated=list(r2.generated),
                             snapshot=_to_reference(r2.snapshot))
    jb = _jengine(jcfg, jparams)
    assert jb.admit_with_state(j2)
    while jb.batcher.n_active:
        jb.step()
    assert [int(t) for t in j2.generated] == _solo(jcfg, jparams, p2, 9)


def test_bf16_snapshot_bits_cross_packages():
    """bf16 rows travel bit for bit: the reference's ml_dtypes rows land in
    the port's cache unchanged, and the port's rows (uint16 bits, dtype
    named) land in the reference's cache unchanged."""
    jcfg, jparams, tcfg, tparams = _setup("recurrentgemma-2b", 3,
                                          dtype="bfloat16")
    prompt = np.random.default_rng(2).integers(0, 250, size=11)
    ja = _jengine(jcfg, jparams)
    r = jserve.ServeRequest(0, prompt, max_new_tokens=6)
    ja.submit(r)
    ja.step()
    [r] = ja.drain_inflight()
    snap = _to_port(r.snapshot)
    assert snap.leaf_dtype("attn", "k") == "bfloat16"
    tb = _engine(tcfg, tparams)
    assert tb.batcher.import_snapshot(tserve.ServeRequest(0, prompt, 6,
                                                          generated=[1]),
                                      snap)
    slot = next(iter(tb.batcher.active))
    for kind, leaves in r.snapshot.rows.items():
        for leaf, a in leaves.items():
            got = tb.batcher.cache[kind][leaf][:, slot]
            assert dtype_name(got.dtype) == a.dtype.name
            if got.dtype == torch.bfloat16:
                np.testing.assert_array_equal(
                    got.view(torch.int16).numpy(), a.view(np.int16))
            else:
                np.testing.assert_array_equal(got.numpy(), a)
    back = tb.batcher.export_snapshot(slot)
    assert back.dtypes["attn"] == {"k": "bfloat16", "v": "bfloat16"}
    assert back.rows["attn"]["k"].dtype == np.uint16
    assert back.nbytes() == r.snapshot.nbytes()
    jb = _jengine(jcfg, jparams)
    assert jb.batcher.import_snapshot(
        jserve.ServeRequest(0, prompt, 6, generated=[1]),
        _to_reference(back))
    jslot = next(iter(jb.batcher.active))
    for kind, leaves in r.snapshot.rows.items():
        for leaf, a in leaves.items():
            np.testing.assert_array_equal(
                np.asarray(jb.batcher.cache[kind][leaf][:, jslot]).view(
                    np.uint8), a.view(np.uint8))


@pytest.mark.parametrize("arch,kw", [CASES[0], CASES[1], CASES[3]],
                         ids=["qwen3", "qwen3-ring", "mamba2"])
def test_batched_import_matches_sequential(arch, kw):
    """Three victims land in ONE scatter with the continuations of three
    sequential imports and of the reference's solo runs."""
    jcfg, jparams, tcfg, tparams = _case(arch, kw)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 250, size=L) for L in (20, 11, 15)]

    def drained_victims():
        a = _engine(tcfg, tparams, n_slots=4)
        reqs = [tserve.ServeRequest(i, p, max_new_tokens=10)
                for i, p in enumerate(prompts)]
        for r in reqs:
            a.submit(r)
        for _ in range(4):
            a.step()
        return a.drain_inflight()

    b = _engine(tcfg, tparams, n_slots=4)
    accepted = b.admit_with_state_batch(drained_victims())
    assert sorted(r.rid for r in accepted) == [0, 1, 2]
    assert b.batcher.n_batched_imports == 1
    assert b.batcher.n_migrated_in == 3
    assert b.batcher.n_prefill_reqs == 0
    _finish(b)
    c = _engine(tcfg, tparams, n_slots=4)
    seq = drained_victims()
    for r in seq:
        assert c.admit_with_state(r)
    _finish(c)
    for x, y in zip(sorted(accepted, key=lambda r: r.rid),
                    sorted(seq, key=lambda r: r.rid)):
        assert x.generated == y.generated
        assert x.generated == _solo(jcfg, jparams, prompts[x.rid], 10)


def test_batched_import_partial_capacity():
    """With fewer free slots than victims the batch takes what fits and
    hands the rest back, snapshot kept."""
    jcfg, jparams, tcfg, tparams = _setup("qwen3-1.7b", 2)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 250, size=10 + i) for i in range(3)]
    a = _engine(tcfg, tparams, n_slots=4)
    for i, p in enumerate(prompts):
        a.submit(tserve.ServeRequest(i, p, max_new_tokens=8))
    for _ in range(3):
        a.step()
    drained = a.drain_inflight()
    b = _engine(tcfg, tparams, n_slots=3)
    resident = tserve.ServeRequest(9, rng.integers(0, 250, size=8),
                                   max_new_tokens=12)
    b.submit(resident)
    b.step()                                     # 2 free slots remain
    accepted = b.admit_with_state_batch(drained)
    assert len(accepted) == 2
    left = [r for r in drained if r.rid not in {x.rid for x in accepted}]
    assert len(left) == 1 and left[0].snapshot is not None
    _finish(b)
    for r in accepted:
        assert r.generated == _solo(jcfg, jparams, prompts[r.rid], 8)
    assert resident.generated == _solo(jcfg, jparams, resident.tokens, 12)


def test_import_refuses_incompatible_snapshot():
    """Another max_len, arch or dtype refuses (False, snapshot kept); the
    re-prefill fallback still finishes exactly."""
    jcfg, jparams, tcfg, tparams = _setup("qwen3-1.7b", 4)
    rng = np.random.default_rng(2)
    a = _engine(tcfg, tparams, max_len=96)
    req = tserve.ServeRequest(0, rng.integers(0, 250, size=8),
                              max_new_tokens=6)
    a.submit(req)
    a.step()
    a.step()
    [req] = a.drain_inflight()
    assert not _engine(tcfg, tparams, max_len=64).admit_with_state(req)
    assert req.snapshot is not None
    _, _, tcfg2, tparams2 = _setup("qwen3-1.7b", 2)
    assert not _engine(tcfg2, tparams2).admit_with_state(req)
    # the same shapes in bf16: the dtype refuses
    _, _, tcfg3, tparams3 = _setup("qwen3-1.7b", 4, dtype="bfloat16")
    assert not _engine(tcfg3, tparams3).admit_with_state(req)
    snap = req.snapshot
    assert not KVSnapshot(snap.arch, snap.max_len, snap.pos, snap.rows,
                          {"attn": {"k": "bfloat16"}}).compatible_with(
        _engine(tcfg, tparams).batcher.cache, tcfg.name, 96)
    assert not _engine(tcfg, tparams).batcher.import_snapshots([])
    d = _engine(tcfg, tparams)
    d.submit(req)
    d.run()
    assert req.generated == _solo(jcfg, jparams, req.tokens, 6)


def test_admit_with_state_respects_epoch_barrier():
    """A batch mid-epoch on another adapter refuses the import, a survivor
    without the adapter refuses it, and an idle survivor with it switches
    and resumes exactly."""
    jcfg, jparams, tcfg, tparams = _setup("qwen3-1.7b", 4)
    lora = jlora.randomize_lora(jax.random.fold_in(KEY, 3),
                                jlora.init_lora(KEY, jcfg, rank=4))
    jmerged = jlora.merge_lora(jparams, lora)
    tmerged = tlora.merge_lora(tparams, tlora.LoRAAdapter(
        lora.name, lora.rank, lora.alpha,
        params_from_jax(jax.tree.map(np.asarray, lora.blocks), "cpu")))
    rng = np.random.default_rng(3)
    a = _engine(tcfg, tparams, adapter_params={"a": tmerged})
    mig = tserve.ServeRequest(0, rng.integers(0, 250, size=8),
                              max_new_tokens=6, adapter="a")
    a.submit(mig)
    a.step()
    a.step()
    [mig] = a.drain_inflight()
    b = _engine(tcfg, tparams, adapter_params={"a": tmerged})
    b.submit(tserve.ServeRequest(1, rng.integers(0, 250, size=8),
                                 max_new_tokens=12))
    b.step()
    assert not b.admit_with_state(mig)
    assert not b.admit_with_state_batch([mig])
    assert not _engine(tcfg, tparams).admit_with_state(mig)
    d = _engine(tcfg, tparams, adapter_params={"a": tmerged})
    assert d.admit_with_state(mig)
    assert d.active_adapter == "a"
    _finish(d)
    assert mig.generated == _solo(jcfg, jmerged, mig.tokens, 6)


def _wipe_layers(batcher, layers):
    """Zero the state of the global layers in ``layers``."""
    for gi, (kind, ki, ai) in enumerate(_kind_indices(batcher.cfg)):
        if gi in layers:
            for a in batcher.cache[kind].values():
                a[ai if kind == "attn" else ki] = 0


def test_reconstruct_inflight_partial_layers():
    """Wipe some layers' K/V under live requests, rebuild only those in
    place: the reference's work stats and solo tokens."""
    jcfg, jparams, tcfg, tparams = _setup("qwen3-1.7b", 4)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 250, size=L) for L in (12, 7)]
    srv = _engine(tcfg, tparams)
    reqs = [tserve.ServeRequest(i, p, max_new_tokens=8)
            for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    for _ in range(3):
        srv.step()
    ptrs = _storage(srv.batcher)
    _wipe_layers(srv.batcher, [1, 2])
    stats = srv.reconstruct_inflight([True, False, False, True])
    assert stats["reconstructed_reqs"] == 2
    assert stats["kv_reused"] == 2       # layer 0, per request
    assert stats["full_prefill"] == 4    # layers 1-2, per request
    assert stats["layers_skipped"] == 2  # layer 3 untouched
    assert stats["q_only_tokens"] > 0 and stats["prefill_tokens"] > 0
    _finish(srv)
    assert _storage(srv.batcher) == ptrs
    for i, p in enumerate(prompts):
        assert reqs[i].generated == _solo(jcfg, jparams, p, 8), i


@pytest.mark.parametrize("arch,kw", CASES,
                         ids=[f"{a}{'-ring' if k else ''}" for a, k in CASES])
def test_relay_inflight_one_scatter_mixed_lengths_exact(arch, kw):
    """Lose layers 1-2 under live mixed-length requests: equal-length slots
    rebuild together, everything lands in ONE scatter, the stats equal the
    reference's relay and the streams its solo runs."""
    jcfg, jparams, tcfg, tparams = _case(arch, kw)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 250, size=L) for L in (10, 13, 13)]
    has = [True, False, False, True]
    runs = []
    for mod, eng, cfg, params in (
            (tserve, _engine, tcfg, tparams),
            (jserve, _jengine, jcfg, jparams)):
        srv = eng(cfg, params, n_slots=4)
        reqs = [mod.ServeRequest(i, p, max_new_tokens=8)
                for i, p in enumerate(prompts)]
        for r in reqs:
            srv.submit(r)
        for _ in range(3):
            srv.step()
        if mod is tserve:
            ptrs = _storage(srv.batcher)
            _wipe_layers(srv.batcher, [1, 2])
        stats = srv.relay_inflight(has)
        assert srv.batcher.n_relay_scatters == 1
        while srv.batcher.n_active:
            srv.step()
        runs.append((srv, reqs, stats))
    (ts, treqs, tstats), (_, jreqs, jstats) = runs
    assert tstats == jstats
    assert tstats["relayed_reqs"] == 3
    assert ts.batcher.n_prefill_reqs == 3          # the admissions only
    assert _storage(ts.batcher) == ptrs
    for i, p in enumerate(prompts):
        assert treqs[i].generated == _solo(jcfg, jparams, p, 8), i
        assert treqs[i].generated == [int(t) for t in jreqs[i].generated]


def test_relay_inflight_noop_when_state_survives():
    _, _, tcfg, tparams = _setup("qwen3-1.7b", 4)
    srv = _engine(tcfg, tparams)
    srv.submit(tserve.ServeRequest(0, np.arange(8), max_new_tokens=4))
    srv.step()
    assert srv.relay_inflight([True] * tcfg.n_layers) == {}
    assert srv.reconstruct_inflight([True] * tcfg.n_layers) == {}
    assert srv.batcher.n_relay_scatters == 0


def test_compile_stats_on_the_cpu():
    """The CPU runs the decode step eagerly (0 captures); prefill counts
    its distinct shapes (the bucket ladder's rungs seen), which
    ``hotpath_stats`` carries too."""
    _, _, tcfg, tparams = _setup("qwen3-1.7b", 2)
    srv = _engine(tcfg, tparams, n_slots=2, max_len=64)
    rng = np.random.default_rng(6)
    for i, L in enumerate((5, 9, 20, 30, 40)):
        srv.submit(tserve.ServeRequest(i, rng.integers(0, 250, size=L),
                                       max_new_tokens=3))
    srv.run()
    assert srv.batcher.compile_stats() == {"decode_compiles": 0,
                                   "prefill_compiles": 3}  # 16, 32, 64
    hot = srv.hotpath_stats()
    assert hot["decode_compiles"] == 0 and hot["prefill_compiles"] == 3
    assert hot["n_batched_imports"] == 0 and hot["n_relay_scatters"] == 0


def test_adapter_switch_copies_into_owned_leaves():
    """An adapter switch copies the merged targets into the batcher's own
    storage (never rebinding a tensor a captured step reads) and keeps
    every shared leaf; a leaf the batcher does not own may be rebound only
    while no step is captured."""
    jcfg, jparams, tcfg, tparams = _setup("qwen3-1.7b", 2)
    ads = {}
    for i in range(2):
        lora = jlora.randomize_lora(jax.random.fold_in(KEY, 10 + i),
                                    jlora.init_lora(KEY, jcfg, rank=4))
        ads[f"l{i}"] = tlora.merge_lora(tparams, tlora.LoRAAdapter(
            lora.name, lora.rank, lora.alpha,
            params_from_jax(jax.tree.map(np.asarray, lora.blocks), "cpu")))
    srv = _engine(tcfg, tparams, adapter_params=ads)
    b = srv.batcher
    owned = {("blocks", "attn", t) for t in tlora.TARGETS}
    assert b._owned == owned
    ptrs = _storage(b)
    for name in ("l0", "l1", None, "l1"):
        srv._switch_adapter(name)
        src = tparams if name is None else ads[name]
        for path, t in tserve._leaves(b.params):
            want = dict(tserve._leaves(src))[path]
            if path in owned:
                assert t is not want and torch.equal(t, want)
            else:
                assert t is want
    assert _storage(b) == ptrs
    other = dict(tparams, final_norm=tparams["final_norm"] + 1.0)
    b.params = other                          # no captured step: rebound
    assert b.params["final_norm"] is other["final_norm"]
    b._graph = object()                       # as if a step were captured
    with pytest.raises(RuntimeError, match="final_norm"):
        b.params = tparams


def test_sampler_swap_drops_the_captured_step():
    _, _, tcfg, tparams = _setup("qwen3-1.7b", 2)
    b = tserve.ContinuousBatcher(tcfg, tparams, 2, 32)
    b._graph, b.n_decode_captures = object(), 1
    b.sampler = tserve.quantized_greedy
    assert b._graph is None and b.compile_stats()["decode_compiles"] == 0


def test_warm_paths_change_no_live_state():
    """``warm_decode`` (a step with every slot frozen) and ``warm_import``
    (slot 0 written onto itself) leave a later request's stream as the
    reference's solo run."""
    jcfg, jparams, tcfg, tparams = _setup("qwen3-1.7b", 4)
    srv = _engine(tcfg, tparams)
    srv.batcher.warm_decode()
    srv.batcher.warm_import()
    assert not srv.batcher.cache["pos"].any()
    prompt = np.random.default_rng(8).integers(0, 250, size=9)
    r = tserve.ServeRequest(0, prompt, max_new_tokens=6)
    srv.submit(r)
    srv.step()
    srv.batcher.warm_import()
    srv.run()
    assert r.generated == _solo(jcfg, jparams, prompt, 6)
    with pytest.raises(ValueError):
        srv.submit(tserve.ServeRequest(1, prompt, max_new_tokens=6))
        srv.step()
        srv.batcher.warm_decode()


def test_snapshot_chain_survives_a_second_crash():
    """The server that absorbed a migrated request crashes too: the
    snapshot chain A -> B -> C still ends on the solo tokens."""
    jcfg, jparams, tcfg, tparams = _setup("qwen3-1.7b", 4)
    prompt = np.random.default_rng(6).integers(0, 250, size=15)
    a = _engine(tcfg, tparams)
    req = tserve.ServeRequest(0, prompt, max_new_tokens=12)
    a.submit(req)
    for _ in range(4):
        a.step()
    [req] = a.drain_inflight()
    pos_a = req.snapshot.pos
    b = _engine(tcfg, tparams)
    assert b.admit_with_state(req)
    for _ in range(3):
        b.step()
    [req] = b.drain_inflight()
    assert req.snapshot.pos > pos_a
    c = _engine(tcfg, tparams)
    assert c.admit_with_state(req)
    _finish(c)
    assert c.batcher.n_prefill_reqs == 0
    assert req.generated == _solo(jcfg, jparams, prompt, 12)
    snap = a.batcher.export_snapshot(0)
    assert snap.pos >= 0 and snap.nbytes() == sum(
        to_numpy(x)[:, 0].nbytes for x in a.batcher.cache["attn"].values())
