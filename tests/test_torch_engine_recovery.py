"""The recovery half of the port's ``PipeBoostEngine`` beside the
reference's (paper §4.4): crash, recover, restart, revive, repartition and
``generate(crash_at=...)``, the peer-delivery and budgeted loading paths,
and the launcher's ``--crash-at`` on the CPU.

Reduced configs in float32, weights from the reference converted with
``params_from_jax``, prompts from numpy.  The event logs,
``lost_state_layers``, the stats dicts and the greedy token streams must be
equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.core import engine as jeng
from repro.models import transformer as JT
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core import engine as teng
from repro_torch.launch import serve

KEY = jax.random.PRNGKey(3)


@functools.lru_cache(maxsize=None)
def _setup(arch, layers):
    jcfg = jget_arch(arch).reduced(n_layers=layers)
    tcfg = get_arch(arch).reduced(n_layers=layers)
    jparams = JT.init_params(jcfg, KEY)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _pair(arch, layers, n_devices=4, **kw):
    jcfg, jparams, tcfg, tparams = _setup(arch, layers)
    return (jeng.PipeBoostEngine(jcfg, jparams, n_devices=n_devices,
                                 max_len=64, **kw),
            teng.PipeBoostEngine(tcfg, tparams, n_devices=n_devices,
                                 max_len=64, **kw))


def _batch(cfg, B=2, S=12, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _plan(e):
    return dataclasses.asdict(e.plan)


def _same_events(je, te):
    assert te.events == je.events


@pytest.mark.parametrize("arch,layers", [
    ("qwen3-1.7b", 8), ("mamba2-780m", 8), ("recurrentgemma-2b", 6)])
def test_generate_through_crash_matches_reference(arch, layers):
    """``generate`` with devices 1 and 2 crashing at step 4: the stream of
    an uncrashed run, the reference's stream, event log and recover
    stats."""
    je, te = _pair(arch, layers)
    je.load_round()
    te.load_round()
    toks = _batch(te.cfg, S=16)
    assert te.lost_state_layers([1, 2]) == je.lost_state_layers([1, 2])
    assert any(te.lost_state_layers([1, 2]))
    jout = jeng.generate(je, {"tokens": jnp.asarray(toks)}, 8, crash_at=4,
                         crash_devices=[1, 2])
    tout = teng.generate(te, {"tokens": torch.from_numpy(toks)}, 8,
                         crash_at=4, crash_devices=[1, 2])
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    ref = teng.PipeBoostEngine(te.cfg, te._full_params, n_devices=4,
                               max_len=64)
    ref.load_round()
    np.testing.assert_array_equal(
        teng.generate(ref, {"tokens": torch.from_numpy(toks)}, 8).numpy(),
        tout.numpy())
    _same_events(je, te)
    [stats] = [p for e, p in te.events if e == "recover"]
    assert stats["replanned"] and stats["reconstruct"]["full_prefill"] > 0


def test_crash_and_recover_step_by_step():
    """Crash during decode, inspect the plan, recover: the reference's
    ``lost_state_layers``, chain, kv ownership and reconstruct stats; a
    second recover with nothing lost skips every layer."""
    je, te = _pair("qwen3-1.7b", 8)
    for e in (je, te):
        e.load_round()
    toks = _batch(te.cfg)
    jl = je.prefill({"tokens": jnp.asarray(toks)})
    tl = te.prefill({"tokens": torch.from_numpy(toks)})
    for _ in range(3):
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = torch.argmax(tl, -1).to(torch.int32)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jl, tl = je.decode(jt), te.decode(tt)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    assert te.lost_state_layers([3]) == je.lost_state_layers([3])
    assert [d.kv_segments for d in te.devices] == \
        [d.kv_segments for d in je.devices]
    for e in (je, te):
        e.crash([3])
    with pytest.raises(teng.EngineError, match="recover"):
        te.decode(torch.argmax(tl, -1).to(torch.int32))
    js, ts = je.recover(), te.recover()
    assert ts == js
    assert ts["reconstruct"]["layers_skipped"] == 0
    assert [d.kv_segments for d in te.devices] == \
        [d.kv_segments for d in je.devices]
    assert te.recover() == je.recover()          # nothing lost now
    jt = jnp.argmax(jl, -1).astype(jnp.int32)
    np.testing.assert_allclose(
        te.decode(torch.from_numpy(np.array(jt))).numpy(),
        np.asarray(je.decode(jt)), atol=1e-4)
    _same_events(je, te)


def test_restart_and_revive_match_reference():
    je, te = _pair("qwen3-1.7b", 8)
    for e in (je, te):
        e.load_round()
        e.crash([1])
        e.revive([1])
    assert _plan(te) == _plan(je)
    assert te.loaded_map() == je.loaded_map()
    assert te.rounds_to_ready() == je.rounds_to_ready()
    for e in (je, te):
        while e.load_round():
            pass
    assert te.fully_loaded and te.chain() == je.chain()
    for e in (je, te):
        e.restart(n_devices=2)
    assert te.n_devices == 2 and _plan(te) == _plan(je)
    assert te._cache is None and te._tokens_seen is None
    assert te.rounds_to_ready() == je.rounds_to_ready() == 1
    assert te.cold_start_stats() == je.cold_start_stats()
    _same_events(je, te)


def test_recover_raises_when_all_devices_are_dead():
    _, te = _pair("qwen3-1.7b", 8, n_devices=2)
    te.crash([0, 1])
    with pytest.raises(teng.EngineError, match="all devices dead"):
        te.recover()


def _gen_with_faults(eng, toks, n, faults, to_dev, argmax):
    tok = argmax(eng.prefill({"tokens": to_dev(toks)}))
    out, stats = [tok], []
    for i in range(1, n):
        if i in faults:
            dead, revive = faults[i]
            stats.append(eng.repartition(dead=dead, revive=revive))
        tok = argmax(eng.decode(tok))
        out.append(tok)
    return out, stats


def test_repartition_shrink_widen_matches_reference():
    """4 -> 3 -> 4 devices mid-generation: the reference's stats and stream,
    the stream of an uncrashed run, and only the lost layers rebuilt."""
    je, te = _pair("qwen3-1.7b", 8)
    for e in (je, te):
        e.load_round()
    toks = _batch(te.cfg)
    faults = {3: ([3], []), 6: ([], [3])}
    jout, jstats = _gen_with_faults(
        je, toks, 10, faults, jnp.asarray,
        lambda lg: jnp.argmax(lg, -1).astype(jnp.int32))
    tout, tstats = _gen_with_faults(
        te, toks, 10, faults, torch.from_numpy,
        lambda lg: torch.argmax(lg, -1).to(torch.int32))
    assert tstats == jstats
    shrink, widen = tstats
    assert shrink["n_alive"] == 3 and widen["n_alive"] == 4
    assert 0 < shrink["lost_layers"] < 8 and widen["lost_layers"] == 0
    assert shrink["reconstruct"]["kv_reused"] > 0
    assert shrink["n_stages"] == 0           # no pipeline prefill ported
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ref = teng.PipeBoostEngine(te.cfg, te._full_params, n_devices=4,
                               max_len=64)
    ref.load_round()
    np.testing.assert_array_equal(
        teng.generate(ref, {"tokens": torch.from_numpy(toks)}, 10).numpy(),
        torch.stack(tout, 1).numpy())
    _same_events(je, te)


def test_repartition_refuses_empty_device_set():
    _, te = _pair("qwen3-1.7b", 8, n_devices=2)
    while te.load_round():
        pass
    with pytest.raises(teng.EngineError, match="all devices dead"):
        te.repartition(dead=[0, 1])


def test_repartition_restarts_background_fill():
    """A repartition mid-fill hands the fill to a fresh thread over the new
    plan, which still loads everything."""
    _, te = _pair("qwen3-1.7b", 8)
    te.load_round()
    te.start_fill(interval_s=0.01)
    assert te.fill_running
    te.repartition(dead=[3])
    deadline = 200
    while not te.fully_loaded and deadline:
        te.load_round()
        deadline -= 1
    assert te.fully_loaded
    te.stop_fill()
    assert not te.fill_running
    assert not te.devices[3].alive


def test_crash_stops_the_background_fill():
    _, te = _pair("qwen3-1.7b", 8)
    te.load_round()
    te.start_fill(interval_s=0.05)
    te.crash([2])
    assert not te.fill_running and te._fill_thread is None
    assert not te.devices[2].alive
    assert [e for e, _ in te.events][-1] == "crash"


def test_budget_and_peer_loads_match_reference():
    """``segments_per_round``, per-call budgets and peer-delivered segments
    account as in the reference."""
    je, te = _pair("qwen3-1.7b", 8, n_segments=8, segments_per_round=2)
    assert te.rounds_to_ready() == je.rounds_to_ready()
    assert te.rounds_to_ready(budget=1) == je.rounds_to_ready(budget=1)
    for e in (je, te):
        e.load_round()
        e.load_segment(1, 7)
        e.load_segment(1, 7)                 # already held: no round
        e.load_round(budget=3)
    assert te.peer_loaded_bytes() == je.peer_loaded_bytes() > 0
    assert [r.source for r in te.rounds] == [r.source for r in je.rounds]
    assert [r.bytes for r in te.rounds] == [r.bytes for r in je.rounds]
    assert len(list(te.fill_steps(budget=1))) == \
        len(list(je.fill_steps(budget=1)))
    assert te.fully_loaded
    _same_events(je, te)


def test_compile_stats_of_the_eager_engine():
    _, te = _pair("qwen3-1.7b", 8)
    te.load_round()
    toks = _batch(te.cfg)
    teng.generate(te, {"tokens": torch.from_numpy(toks)}, 3)
    teng.generate(te, {"tokens": torch.from_numpy(toks[:1])}, 2)
    assert te.compile_stats() == {"decode_compiles": 0,
                                  "prefill_compiles": 2,
                                  "pipeline_prefill_compiles": 0}


def test_serve_cli_crash_at_cpu(capsys):
    res = serve.main(["--device", "cpu", "--requests", "2", "--adapters",
                      "0", "--new-tokens", "5", "--max-len", "96",
                      "--prompt-len", "8-20", "--crash-at", "2",
                      "--seed", "2"])
    out = capsys.readouterr().out
    assert "injecting crash on device 1" in out
    assert "recovered: {'layers_recomputed'" in out
    assert "decode continued through the crash" in out
    assert res.crash["tokens"].shape == (1, 5)
    assert "reconstruct" in res.crash["recover"]
