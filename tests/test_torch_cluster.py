"""The port's serverless cluster layer on real servers against the JAX
package's: the same trace runs through the reference ``ClusterRouter``
(JAX servers) and the port's (``repro_torch`` servers on the CPU), with
weights converted by ``params_from_jax``.

Every case must give equal per-request token streams, equal
``metrics.summary()`` and equal event logs, and equal logical fields of
each server's ``cold_start_record``.  Three summary keys are measured, not
replayed: ``hotpath_decode_time_s`` and ``hotpath_decode_steps_per_s``
are wall-clock times, and ``hotpath_decode_compiles`` counts the
reference's jit compiles of the decode step, where the port on the CPU
runs the step eagerly and counts 0 captures.  Those three are checked for
what they are instead.

Dispatch runs ``least_loaded`` or ``adapter_affine`` on the logical
clock: ``SloAware`` reads the measured step cost, so its choices on real
servers depend on wall time (it is held to the reference on modeled
servers in ``tests/test_torch_cluster_sim.py``).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

import repro.cluster as JC
import repro_torch.cluster as TC
from repro.configs.base import get_arch as jget_arch
from repro.lora import adapters as jlora
from repro.models import transformer as JT
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tlaunch
from repro_torch.lora import adapters as tlora

KEY = jax.random.PRNGKey(5)
ARCH = "qwen3-1.7b"
MEASURED = ("hotpath_decode_time_s", "hotpath_decode_steps_per_s",
            "hotpath_decode_compiles")
LOGICAL_COLDSTART = ("server", "time_to_ready", "time_to_fully_loaded",
                     "served_while_loading", "loaded_bytes", "total_bytes",
                     "n_rounds")


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = jget_arch(ARCH).reduced(n_layers=2)
    tcfg = get_arch(ARCH).reduced(n_layers=2)
    jp = JT.init_params(jcfg, KEY)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jad, tad = {}, {}
    for i in range(2):
        lora = jlora.randomize_lora(
            jax.random.fold_in(KEY, 10 + i),
            jlora.init_lora(KEY, jcfg, rank=4, name=f"lora{i}"))
        jad[lora.name] = jlora.merge_lora(jp, lora)
        tad[lora.name] = tlora.merge_lora(tp, tlora.LoRAAdapter(
            lora.name, lora.rank, lora.alpha,
            params_from_jax(jax.tree.map(np.asarray, lora.blocks), "cpu")))
    return {"jax": (JC, jcfg, jp, jad), "torch": (TC, tcfg, tp, tad)}


def _wave(C, adapters, seed):
    return C.burst_wave_trace(14, base_rate=2.0, wave_rate=16.0, wave_at=0.5,
                              wave_len=1.0, seed=seed, max_new_tokens=6,
                              adapters=adapters)


def _prefix_trace(C):
    """Two waves of shared-prefix prompts with an idle gap between them
    long enough to retire the scaled-up server (times off the tick grid)."""
    w1 = C.repeated_prefix_trace(8, prefix_len=24, suffix_len=4,
                                 gap_s=0.021, seed=0, max_new_tokens=4)
    w2 = C.repeated_prefix_trace(6, prefix_len=24, suffix_len=4,
                                 gap_s=0.011, seed=100, max_new_tokens=4)
    return w1 + [dataclasses.replace(a, time=a.time + 4.003) for a in w2]


# name -> (ClusterConfig kwargs, run kwargs, extras); the traces' seeds
# are picked so that each case reaches the path it names
# (test_cluster_cases_exercise_their_paths)
WHOLE = {"crash_after_completions": 3, "rejoin_after_ticks": 10}
PARTIAL = {"crash_after_completions": 2, "crash_devices": [0]}
BASE = {"adapters": (), "seed": 4}
CASES = {
    "migrate": ({"migrate_on_crash": True}, WHOLE, BASE),
    "reprefill": ({"migrate_on_crash": False}, WHOLE, BASE),
    "partial-reconstruct": ({"partial_recovery": "reconstruct"}, PARTIAL,
                            BASE),
    "partial-repartition": ({"partial_recovery": "repartition"}, PARTIAL,
                            BASE),
    "chaos": ({}, {}, {"chaos": True, "seed": 3}),
    "adapter-affine": ({}, WHOLE, {"dispatch": "adapter_affine",
                                   "seed": 3}),
    "prefix-tier": ({"prefix_cache_bytes": 8 << 20}, {},
                    {"tier": True, "adapters": ()}),
}


def _run(side, case, engine="event"):
    C, cfg, params, ads = _setup()[side]
    ckw, rkw, extra = CASES[case]
    ads = {k: ads[k] for k in extra.get("adapters", ads)}
    if extra.get("tier"):
        trace = _prefix_trace(C)
        scaler = C.Autoscaler(C.AutoscalerConfig(
            min_servers=1, max_servers=2, target_queue_per_server=2,
            idle_ticks_before_retire=20))
    else:
        trace = _wave(C, tuple(ads), extra["seed"])
        scaler = C.Autoscaler(C.AutoscalerConfig(
            target_queue_per_server=2, max_servers=3, ttft_slo_s=1.0))
    if extra.get("chaos"):
        rkw = dict(rkw, chaos=C.random_chaos(
            3, horizon=3.0, n_servers=2, seed=11, n_devices=2,
            partial_prob=0.5, rejoin_delay_s=0.6))
    ccfg = C.ClusterConfig(n_devices=2, n_slots=2, max_len=96, **ckw)
    router = C.ClusterRouter(
        cfg, params, n_servers=2, ccfg=ccfg, autoscaler=scaler,
        adapter_params=ads,
        dispatch=C.make_dispatch(extra.get("dispatch", "least_loaded")),
        state_tier=C.StateTier() if extra.get("tier") else None)
    done = router.run(trace, engine=engine, **rkw)
    return router, {r.rid: list(r.generated) for r in done}, len(trace)


@functools.lru_cache(maxsize=None)
def _pair(case):
    return _run("jax", case), _run("torch", case)


def _coldstart(router):
    return {sid: {k: rec[k] for k in LOGICAL_COLDSTART}
            for sid, rec in router.metrics.coldstart.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_cluster_streams_and_events_equal_reference(case):
    (jr, jdone, n), (tr, tdone, _) = _pair(case)
    assert len(tdone) == n
    assert tdone == jdone
    assert tr.metrics.events == jr.metrics.events
    assert _coldstart(tr) == _coldstart(jr)


@pytest.mark.parametrize("case", list(CASES))
def test_cluster_summary_equals_reference(case):
    (jr, _, n), (tr, _, _) = _pair(case)
    js, ts = jr.metrics.summary(), tr.metrics.summary()
    assert set(ts) == set(js)
    assert {k: v for k, v in ts.items() if k not in MEASURED} == \
        {k: v for k, v in js.items() if k not in MEASURED}
    assert ts["n_completed"] == n
    # measured keys: the same steps were timed, the port's CPU step runs
    # eagerly (0 captures), the reference compiled once per decoding server
    assert ts["hotpath_decode_time_s"] > 0
    assert ts["hotpath_decode_compiles"] == 0
    assert js["hotpath_decode_compiles"] >= 1


def test_cluster_cases_exercise_their_paths():
    """Each case reaches the path it names (so equality is not vacuous)."""
    s = {c: _pair(c)[1][0].metrics.summary() for c in CASES}
    kinds = {c: [k for _, k, _ in _pair(c)[1][0].metrics.events]
             for c in CASES}
    assert s["migrate"]["recovery_mode_migrate"] > 0
    assert s["reprefill"]["recovery_mode_reprefill"] > 0
    assert s["reprefill"]["recovery_mode_migrate"] == 0
    assert s["partial-reconstruct"]["recovery_mode_reconstruct"] > 0
    assert s["partial-repartition"]["recovery_mode_repartition"] > 0
    assert {"crash", "recover", "rejoin"} <= set(kinds["chaos"])
    assert s["adapter-affine"]["n_rerouted"] > 0
    assert any(r.adapter for r in _pair("adapter-affine")[1][0].servers[0]
               .srv.completed)
    assert "rejoin" in kinds["migrate"]
    assert s["prefix-tier"]["prefix_hits"] > 0
    assert s["prefix-tier"]["spill_resurrections"] == 1
    assert "spill" in kinds["prefix-tier"]
    assert "resurrect" in kinds["prefix-tier"]


@pytest.mark.parametrize("case", ["migrate", "prefix-tier"])
def test_tick_engine_equals_event_engine(case):
    """The event engine's oracle (``tests/test_events.py``), on the port:
    the polling loop gives the same streams, summary and events."""
    ev, ev_done, _ = _pair(case)[1]
    tk, tk_done, _ = _run("torch", case, engine="tick")
    assert tk_done == ev_done
    es, ts = ev.metrics.summary(), tk.metrics.summary()
    for k in es:
        if k not in MEASURED and k != "gpu_seconds":
            assert ts[k] == pytest.approx(es[k], abs=1e-9), k
    assert ts["gpu_seconds"] == pytest.approx(es["gpu_seconds"], rel=1e-9)
    assert [e[1:] for e in tk.metrics.events] == \
        [e[1:] for e in ev.metrics.events]


def test_retired_server_releases_device_state():
    """An idle-retired server frees its batcher's cache, owned leaves and
    step I/O; the router keeps it only for its records."""
    tr = _pair("prefix-tier")[1][0]
    retired = [s for s in tr.servers if s.state == "retired"]
    assert retired
    for s in retired:
        b = s.srv.batcher
        assert b.cache is None and b.params is None
        assert b._dev_tokens is None and b._graph is None
        assert s.srv.hotpath_stats()["n_prefill_calls"] >= 0


def test_launcher_cluster_on_cpu(capsys, tmp_path):
    """``python -m repro_torch.launch.serve --cluster --device cpu``."""
    out = tmp_path / "m.json"
    res = tlaunch.main(["--cluster", "--device", "cpu", "--servers", "2",
                        "--requests", "10", "--crash-at", "3",
                        "--new-tokens", "6", "--max-len", "96",
                        "--prompt-len", "8-24", "--adapters", "1",
                        "--metrics-json", str(out)])
    text = capsys.readouterr().out
    assert "cluster: 10/10 requests completed" in text
    assert "TTFT" in text and "TBT" in text
    s = res.router.metrics.summary()
    assert s["n_completed"] == 10 and s["n_rerouted"] > 0
    assert out.exists()
    assert all(r.srv.cfg.n_layers == 4 for r in res.router.servers)
