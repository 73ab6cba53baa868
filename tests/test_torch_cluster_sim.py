"""The port's own copies of the reference's plain-Python cluster modules
(``cluster/{traces,metrics,scheduler,autoscaler,state_tier,multicast,
simserver,fleet}.py``, ``core/simulator.py``, ``core/analytic.py``) held
to the reference's: every trace generator for the same seeds, the Azure
fixture, the simulator's outputs, and modeled ``SimServer`` fleets
(SLO-aware dispatch, multicast scale-out, autoscaler retire and respawn,
the state tier, chaos, multi-pool ``Fleet``) with equal streams,
summaries and event logs.  No JAX runs here beyond the imports.
"""
import dataclasses
from pathlib import Path

import pytest

import repro.cluster as JC
import repro.cluster.traces as JT
import repro_torch.cluster as TC
import repro_torch.cluster.traces as TT
from repro.configs.base import get_arch as jget_arch
from repro.core import analytic as jan
from repro.core import simulator as jsim
from repro_torch.configs.base import get_arch
from repro_torch.core import analytic as tan
from repro_torch.core import simulator as tsim

AZURE = str(Path(__file__).parent / "fixtures" / "azure_sample.csv")
SIDES = ((JC, JT), (TC, TT))

GENERATORS = {
    "poisson": lambda C, T, s: C.poisson_trace(
        8.0, 3.0, seed=s, max_new_tokens=5, adapters=("a", "b"),
        ttft_deadline_s=0.4),
    "gamma": lambda C, T, s: C.gamma_trace(6.0, 4.0, burstiness=5.0,
                                           seed=s, model="m"),
    "burst_wave": lambda C, T, s: C.burst_wave_trace(
        20, seed=s, prompt_len=12, adapters=("a",), adapter_prob=0.3),
    "repeated_prefix": lambda C, T, s: C.repeated_prefix_trace(
        9, prefix_len=16, suffix_len=5, n_prefixes=3, gap_s=0.07, seed=s),
    "merge": lambda C, T, s: C.merge_traces(
        C.poisson_trace(5.0, 2.0, seed=s, model="x"),
        C.burst_wave_trace(8, seed=s + 1, model="y")),
    "azure": lambda C, T, s: C.load_azure_trace(
        AZURE, minute_s=2.0, seed=s, models=("p", "q"),
        adapters=(None, "a"), ttft_deadline_s=0.5),
    "azure_iter": lambda C, T, s: list(C.iter_azure_trace(
        AZURE, minute_s=2.0, rate_scale=1.5, seed=s, max_requests=40)),
}


def _asdict(trace):
    return [dataclasses.asdict(a) for a in trace]


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("name", list(GENERATORS))
def test_trace_generators_equal_reference(name, seed):
    ref, port = (GENERATORS[name](C, T, seed) for C, T in SIDES)
    assert len(port) > 0
    assert _asdict(port) == _asdict(ref)
    for a in port[:6]:
        j = JC.Arrival(**dataclasses.asdict(a))
        assert (TT.prompt_tokens(a, 32000).tolist()
                == JT.prompt_tokens(j, 32000).tolist())


def test_trace_and_chaos_files_cross_packages(tmp_path):
    """A trace or chaos schedule saved by one package loads in the other."""
    tr = TC.burst_wave_trace(12, seed=4, adapters=("lora0",),
                             ttft_deadline_s=0.5)
    TC.save_trace(str(tmp_path / "t.json"), tr)
    assert _asdict(JC.load_trace(str(tmp_path / "t.json"))) == _asdict(tr)
    ch = [C.random_chaos(4, horizon=5.0, n_servers=3, seed=9, n_devices=2,
                         partial_prob=0.5, load_fault_prob=0.3)
          for C, _ in SIDES]
    assert [dataclasses.asdict(e) for e in ch[1]] == \
        [dataclasses.asdict(e) for e in ch[0]]
    JC.save_chaos(str(tmp_path / "c.json"), ch[0])
    back = TC.load_chaos(str(tmp_path / "c.json"))
    assert [dataclasses.asdict(e) for e in back] == \
        [dataclasses.asdict(e) for e in ch[0]]


@pytest.mark.parametrize("arch", ["pipeboost-opt-1.3b", "qwen3-1.7b",
                                  "mamba2-780m", "recurrentgemma-2b",
                                  "qwen2-moe-a2.7b"])
def test_analytic_and_simulator_equal_reference(arch):
    """The FLOP and byte models and every simulator entry point give the
    reference's numbers (the modelled hardware of the paper)."""
    jcfg, tcfg = jget_arch(arch), get_arch(arch)
    assert tan.layer_bytes_list(tcfg) == jan.layer_bytes_list(jcfg)
    assert tan.param_bytes(tcfg) == jan.param_bytes(jcfg)
    assert tan.embed_bytes(tcfg) == jan.embed_bytes(jcfg)
    for b, s, kv in ((1, 128, 0), (4, 1, 512)):
        assert tan.forward_flops(tcfg, b, s, kv_len=kv) == \
            jan.forward_flops(jcfg, b, s, kv_len=kv)
    for hw in ("GPU_PAPER", "TPU_V5E"):
        jhw, thw = getattr(jsim, hw), getattr(tsim, hw)
        assert dataclasses.asdict(thw) == dataclasses.asdict(jhw)
        for n in (1, 2, 4):
            for strat in ("transformers", "serverlessllm", "pipeboost"):
                assert dataclasses.asdict(
                    tsim.simulate_cold_start(tcfg, thw, n, strat)) == \
                    dataclasses.asdict(
                        jsim.simulate_cold_start(jcfg, jhw, n, strat))
        assert tsim.prefill_time(tcfg, thw, 2, 256) == \
            jsim.prefill_time(jcfg, jhw, 2, 256)
        assert tsim.decode_step_time(tcfg, thw, 4, 300) == \
            jsim.decode_step_time(jcfg, jhw, 4, 300)
        nb = tsim.kv_snapshot_bytes(tcfg, 200, 1024)
        assert nb == jsim.kv_snapshot_bytes(jcfg, 200, 1024)
        for link in tsim.SNAPSHOT_LINKS:
            assert tsim.snapshot_transfer_time(nb, thw, link=link) == \
                jsim.snapshot_transfer_time(nb, jhw, link=link)
        assert tsim.state_resurrect_time(nb, thw, 3) == \
            jsim.state_resurrect_time(nb, jhw, 3)
        for mode in ("pp", "full"):
            assert dataclasses.asdict(tsim.simulate_loading_failure(
                tcfg, thw, 4, [1], mode=mode)) == dataclasses.asdict(
                    jsim.simulate_loading_failure(jcfg, jhw, 4, [1],
                                                  mode=mode))
        for mode in ("pp", "full"):
            assert tsim.simulate_inference_failure(tcfg, thw, 4,
                                                   mode=mode) == \
                jsim.simulate_inference_failure(jcfg, jhw, 4, mode=mode)
        assert tsim.simulate_request_latency(tcfg, thw, 2, 3.0) == \
            jsim.simulate_request_latency(jcfg, jhw, 2, 3.0)


# ---------------------------------------------------------------------------
# modeled fleets: the same scenario through each package's router
# ---------------------------------------------------------------------------

def _autoscaled(C, dispatch):
    trace = C.poisson_trace(40.0, 1.0, seed=7, max_new_tokens=4,
                            ttft_deadline_s=0.5)
    trace += [C.Arrival(a.time + 6.0, max_new_tokens=4, seed=a.seed,
                        ttft_deadline_s=0.5)
              for a in C.poisson_trace(30.0, 0.8, seed=8)]
    trace += [C.Arrival(15.013, max_new_tokens=4, seed=1)]
    r = C.ClusterRouter(
        None, None, n_servers=2, ccfg=C.ClusterConfig(n_devices=1,
                                                      n_slots=4),
        autoscaler=C.Autoscaler(C.AutoscalerConfig(
            target_queue_per_server=4.0, ttft_slo_s=0.4, max_servers=6,
            min_servers=1, scale_up_cooldown_ticks=3,
            idle_seconds_before_retire=1.0)),
        dispatch=dispatch(C),
        server_factory=C.sim_server_factory(C.SimProfile(ready_ticks=2,
                                                         full_ticks=6)),
        materialize_prompts=False)
    return r, trace, {}


def _multicast(C, topology):
    sim = tsim if C is TC else jsim
    hw = dataclasses.replace(sim.GPU_PAPER,
                             host_agg_bw=sim.GPU_PAPER.host_link_bw)
    prof = C.SimProfile(ready_ticks=2, full_ticks=10, bytes_total=1 << 30,
                        n_segments=8)
    r = C.ClusterRouter(None, None, n_servers=4, ccfg=C.ClusterConfig(
        n_devices=1, n_slots=4, tick_s=0.05,
        multicast=C.MulticastConfig(topology=topology, hw=hw)),
        server_factory=C.sim_server_factory(prof), materialize_prompts=False)
    trace = [C.Arrival(2.0 + 0.01 * i, prompt_len=8, max_new_tokens=4)
             for i in range(8)] + [C.Arrival(5.0, prompt_len=8,
                                             max_new_tokens=1)]
    chaos = C.ChaosSchedule([C.ChaosEvent(0.123, "source_crash", 0),
                             C.ChaosEvent(1.0, "rejoin", 0)])
    return r, trace, {"chaos": chaos}


def _tier(C):
    import types
    ccfg = C.ClusterConfig(tick_s=0.05, n_slots=4,
                           prefix_cache_bytes=64 << 20)
    auto = C.Autoscaler(C.AutoscalerConfig(min_servers=1, max_servers=2,
                                           idle_ticks_before_retire=20))
    w1 = C.repeated_prefix_trace(16, prefix_len=24, suffix_len=4,
                                 gap_s=0.021, seed=0)
    w2 = C.repeated_prefix_trace(12, prefix_len=24, suffix_len=4,
                                 gap_s=0.011, seed=100)
    trace = w1 + [dataclasses.replace(a, time=a.time + 8.003) for a in w2]
    r = C.ClusterRouter(
        types.SimpleNamespace(vocab_size=250, name="m"), None, n_servers=2,
        ccfg=ccfg, autoscaler=auto,
        dispatch=C.SloAware(step_cost_s=0.05, prefix_bonus_s_per_token=1e-3),
        clock=C.LogicalClock(), metrics=C.ClusterMetrics(),
        server_factory=C.sim_server_factory(C.SimProfile()),
        state_tier=C.StateTier())
    return r, trace, {}


def _chaos(C):
    r = C.ClusterRouter(
        None, None, n_servers=2, ccfg=C.ClusterConfig(n_devices=4,
                                                      n_slots=4),
        autoscaler=C.Autoscaler(C.AutoscalerConfig(
            target_queue_per_server=4.0, max_servers=4, min_servers=1,
            idle_seconds_before_retire=1.0)),
        dispatch=C.LeastLoaded(),
        server_factory=C.sim_server_factory(C.SimProfile(ready_ticks=2,
                                                         full_ticks=6)),
        materialize_prompts=False)
    chaos = C.random_chaos(4, horizon=4.0, n_servers=2, seed=11,
                           n_devices=4, partial_prob=0.5,
                           rejoin_delay_s=1.0)
    trace = C.poisson_trace(30.0, 2.0, seed=7, max_new_tokens=4)
    return r, trace, {"chaos": chaos}


SCENARIOS = {
    "slo_aware": lambda C: _autoscaled(C, lambda C: C.SloAware()),
    "least_loaded": lambda C: _autoscaled(C, lambda C: C.LeastLoaded()),
    "adapter_affine": lambda C: _autoscaled(C,
                                            lambda C: C.AdapterAffine()),
    "multicast_tree": lambda C: _multicast(C, "tree"),
    "multicast_chain": lambda C: _multicast(C, "chain"),
    "state_tier": _tier,
    "chaos": _chaos,
}


def _replay(C, name, engine):
    r, trace, kw = SCENARIOS[name](C)
    done = r.run(trace, engine=engine, **kw)
    return ({q.rid: list(q.generated) for q in done}, r.metrics.summary(),
            r.metrics.events, r.metrics.coldstart)


@pytest.mark.parametrize("engine", ["event", "tick"])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sim_router_equals_reference(name, engine):
    ref, port = (_replay(C, name, engine) for C, _ in SIDES)
    assert port[0] == ref[0] and len(port[0]) > 0
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert port[3] == ref[3]


def test_sim_scenarios_reach_their_paths():
    s = {n: _replay(TC, n, "event") for n in SCENARIOS}
    kinds = {n: {k for _, k, _ in v[2]} for n, v in s.items()}
    assert {"scale_up", "retire"} <= kinds["slo_aware"]
    assert s["multicast_tree"][1]["multicast_peer_bytes"] > 0
    assert s["multicast_tree"][1]["multicast_reroots"] > 0
    assert {"spill", "resurrect"} <= kinds["state_tier"]
    assert s["state_tier"][1]["prefix_hits"] > 0
    assert {"crash", "rejoin"} <= kinds["chaos"]


def _fleet(C):
    ccfg = C.ClusterConfig(n_devices=1, n_slots=4)
    prof = C.SimProfile(ready_ticks=2, full_ticks=6)
    fleet = C.Fleet({
        "chat": C.PoolSpec(None, None, n_servers=1, ccfg=ccfg,
                           server_factory=C.sim_server_factory(prof),
                           materialize_prompts=False,
                           autoscaler=C.Autoscaler(C.AutoscalerConfig(
                               max_servers=3, idle_seconds_before_retire=1.0,
                               target_queue_per_server=2.0))),
        "code": C.PoolSpec(None, None, n_servers=1, ccfg=ccfg,
                           server_factory=C.sim_server_factory(prof),
                           materialize_prompts=False,
                           dispatch=C.SloAware()),
    })
    trace = C.merge_traces(
        C.poisson_trace(20.0, 1.5, seed=3, model="chat", max_new_tokens=4),
        C.burst_wave_trace(12, seed=4, model="code", max_new_tokens=3))
    return fleet, trace


@pytest.mark.parametrize("engine", ["event", "tick"])
def test_sim_fleet_equals_reference(engine):
    out = []
    for C, _ in SIDES:
        fleet, trace = _fleet(C)
        done = fleet.run(trace, engine=engine)
        out.append(({q.rid: list(q.generated) for q in done},
                    fleet.metrics.summary(), fleet.metrics.summary_by_model(),
                    fleet.metrics.events))
    assert out[1] == out[0]
    assert set(out[1][2]) == {"chat", "code"}
