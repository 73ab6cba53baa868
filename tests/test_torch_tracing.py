"""The serving step's records and spans (``serving/tracing.py``) and the
replay launch counts (``kernels/ops.py``), on the CPU.

pipeboost-opt-1.3b reduced, in float32, with two merged adapters, served
by the port's ``ServingEngine``: each prefill and decode record and each
switch span against the counters and shapes it stands for, the rings'
bound, the records' clock, and the span tree, in memory and as
``torch.profiler`` ranges.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import get_arch
from repro_torch.core.adapter_scheduler import EpochSchedulerPolicy
from repro_torch.kernels import ops
from repro_torch.lora import adapters as tlora
from repro_torch.models import transformer
from repro_torch.serving import engine as tserve
from repro_torch.serving import tracing

ADAPTERS = [None, "lora0", "lora1"]
HOTPATH_KEYS = {
    "n_decode_steps", "decode_time_s", "decode_steps_per_s",
    "n_prefill_calls", "n_prefill_reqs", "n_prefill_pipeline",
    "n_batched_imports", "n_relay_scatters", "n_prefill_tokens",
    "prefix_hits", "prefix_hit_tokens", "prefix_evictions",
    "decode_compiles", "prefill_compiles"}


@pytest.fixture(scope="module")
def opt():
    cfg = get_arch("pipeboost-opt-1.3b").reduced(n_layers=4)
    gen = torch.Generator().manual_seed(5)
    params = transformer.init_params(cfg, gen, torch.float32, "cpu")
    merged = {}
    for name in ADAPTERS[1:]:
        ad = tlora.randomize_lora(gen, tlora.init_lora(
            gen, cfg, 4, name=name, device="cpu"))
        merged[name] = tlora.merge_lora(params, ad)
    return cfg, params, merged


@pytest.fixture
def tr(monkeypatch):
    """A fresh tracer in place of the module's, tracing off."""
    t = tracing.Tracer()
    monkeypatch.setattr(tracing, "TRACER", t)
    monkeypatch.setattr(tserve, "TRACER", t)
    return t


def _engine(opt):
    cfg, params, merged = opt
    eng = tserve.ServingEngine(
        cfg, params, n_slots=3, max_len=64,
        policy=EpochSchedulerPolicy(epoch_budget=2, max_batch=3),
        adapter_params=merged)
    eng.batcher.sampler = tserve.quantized_greedy
    return eng


def _requests(n, seed=0, adapters=ADAPTERS):
    rng = np.random.default_rng(seed)
    return [tserve.ServeRequest(
        i, rng.integers(0, 257, size=int(rng.choice([5, 13, 23, 40]))),
        max_new_tokens=3 + i % 3, adapter=adapters[i % len(adapters)])
        for i in range(n)]


def _serve(eng, reqs, now=None, max_steps=200):
    for r in reqs:
        eng.submit(r)
    for i in range(max_steps):
        eng.step(now=None if now is None else now + i)
        if eng.idle:
            return
    raise AssertionError("the engine did not drain")


def test_tracing_off_records_no_span_and_enters_no_range(opt, tr,
                                                         monkeypatch):
    entered = []
    for mod, attr in ((torch.profiler, "record_function"),
                      (torch._C._profiler, "_RecordFunctionFast")):
        def counting(name, _real=getattr(mod, attr)):
            entered.append(name)
            return _real(name)

        monkeypatch.setattr(mod, attr, counting)
    eng = _engine(opt)
    _serve(eng, _requests(6))
    assert len(tr.decode) > 0 and len(tr.prefill) > 0
    assert list(tr.spans) == [] and entered == []
    assert tr.span("x") is tracing.NO_SPAN
    # the counter sees the ranges once a profiler records
    with profile(activities=[ProfilerActivity.CPU]):
        _serve(eng, _requests(2, seed=1))
    assert "batcher.decode.launch" in entered and len(tr.spans) > 0


def test_decode_parts_sum_to_decode_time(opt, tr):
    eng = _engine(opt)
    d0, n0 = eng.batcher.decode_time_s, eng.batcher.n_decode_steps
    _serve(eng, _requests(7))
    recs = list(tr.decode)
    assert len(recs) == eng.batcher.n_decode_steps - n0 > 0
    parts = sum(r.io + r.launch + r.wait + r.book for r in recs)
    assert abs(parts - (eng.batcher.decode_time_s - d0)) < 1e-6
    assert all(min(r.io, r.launch, r.wait, r.book) >= 0 for r in recs)
    assert all(1 <= r.live <= 3 for r in recs)


def test_prefill_tokens_shape_and_cache_bytes(opt, tr, monkeypatch):
    built = []
    real = transformer.forward

    def recording(cfg, params, batch, **kw):
        logits, cache = real(cfg, params, batch, **kw)
        built.append((tuple(batch["tokens"].shape), sum(
            t.nbytes for _, t in tserve._leaves(cache))))
        return logits, cache

    monkeypatch.setattr(transformer, "forward", recording)
    eng = _engine(opt)
    n0 = eng.batcher.n_prefill_tokens
    _serve(eng, _requests(8))
    recs = list(tr.prefill)
    assert sum(r.tokens for r in recs) == eng.batcher.n_prefill_tokens - n0
    assert len(recs) == len(built) == eng.batcher.n_prefill_calls
    for r, (shape, nbytes) in zip(recs, built):
        assert (r.rows, r.bucket) == shape
        assert r.rows == 3 and r.backend == "single"
        assert r.cache_bytes == nbytes > 0
        assert 1 <= r.requests <= 3 and r.tokens <= r.rows * r.bucket
        assert r.seconds > 0


def _switches(tr):
    return [s.attrs for s in tr.spans if s.name == "engine.switch"]


def test_a_switch_record_for_each_change_of_adapter(opt, tr):
    tracing.enable()
    eng = _engine(opt)
    _serve(eng, _requests(6))
    sw = _switches(tr)
    assert len(sw) == eng.n_adapter_switches > 0
    assert sw[0]["src"] is None
    for a, b in zip(sw, sw[1:]):
        assert a["dst"] == b["src"] and b["src"] != b["dst"]
    n = len(sw)
    eng._switch_adapter(eng.active_adapter)        # a repeat: no switch
    assert len(_switches(tr)) == n
    other = "lora1" if eng.active_adapter != "lora1" else "lora0"
    eng._switch_adapter(other)
    assert len(_switches(tr)) == n + 1 == eng.n_adapter_switches
    assert _switches(tr)[-1]["dst"] == other
    tracing.disable()


def test_records_carry_the_step_clock(opt, tr):
    eng = _engine(opt)
    _serve(eng, _requests(4), now=1000.25)
    times = {1000.25 + i for i in range(200)}
    recs = list(tr.prefill) + list(tr.decode)
    assert recs and all(r.clock in times for r in recs)
    assert tr.prefill[0].clock == 1000.25
    tr.clear()
    _serve(eng, _requests(4, seed=2))                 # step() without now
    recs = list(tr.prefill) + list(tr.decode)
    assert recs and all(r.clock is None for r in recs)
    assert not {r.clock for r in recs} & times
    assert tr.clock is None                           # restored after a step


def test_rings_stop_at_their_maxlen(opt, monkeypatch):
    t = tracing.Tracer(maxlen=3)
    monkeypatch.setattr(tracing, "TRACER", t)
    monkeypatch.setattr(tserve, "TRACER", t)
    tracing.enable()
    eng = _engine(opt)
    _serve(eng, _requests(18), now=0.0)
    assert min(eng.batcher.n_decode_steps, eng.batcher.n_prefill_calls,
               eng.n_adapter_switches) > 3
    for ring in (t.prefill, t.decode, t.spans):
        assert len(ring) == 3
    assert t.decode[-1].clock == max(r.clock for r in t.decode)


def _contains(outer, inner):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_span_tree_in_the_profiler_and_in_memory(opt, tr):
    eng = _engine(opt)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(eng, _requests(3))
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        by_name.setdefault(e.name(), []).append((s, s + e.duration_ns()))
    launches = by_name["batcher.decode.launch"]
    assert launches and by_name["batcher.prefill"]
    for ln in launches:
        dec = [d for d in by_name["batcher.decode"] if _contains(d, ln)]
        assert dec and any(_contains(s, dec[0])
                           for s in by_name["engine.step"])
    for ph in ("io", "wait", "book"):
        assert len(by_name[f"batcher.decode.{ph}"]) == len(launches)
    # the same tree, with parent ids, from enable() alone
    tr.spans.clear()
    tracing.enable()
    _serve(eng, _requests(3, seed=3))
    spans = {s.id: s for s in tr.spans}
    names = {s.name for s in spans.values()}
    assert {"engine.step", "engine.admit", "engine.switch", "batcher.prefill",
            "batcher.decode", "batcher.decode.io", "batcher.decode.launch",
            "batcher.decode.wait", "batcher.decode.book"} <= names

    def chain(s):
        out = [s.name]
        while s.parent is not None:
            s = spans[s.parent]
            out.append(s.name)
        return out

    for s in spans.values():
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        if s.name == "batcher.decode.launch":
            assert chain(s) == ["batcher.decode.launch", "batcher.decode",
                                "engine.step"]
        elif s.name == "batcher.prefill":
            assert chain(s) == ["batcher.prefill", "engine.admit",
                                "engine.step"]
            assert s.attrs["rows"] == 3 and s.attrs["backend"] == "single"
        elif s.name == "engine.switch":
            assert chain(s)[1:] == ["engine.admit", "engine.step"]
    tracing.disable()
    assert tr.span("x") is tracing.NO_SPAN


def test_hotpath_stats_keep_their_keys_and_values(opt, tr):
    runs = []
    for on in (False, True):
        (tracing.enable if on else tracing.disable)()
        eng = _engine(opt)
        reqs = _requests(7, seed=4)
        _serve(eng, reqs)
        runs.append((eng.hotpath_stats(), [r.generated for r in reqs],
                     eng.n_adapter_switches))
    tracing.disable()
    (off, toks_off, sw_off), (on, toks_on, sw_on) = runs
    assert set(off) == set(on) == HOTPATH_KEYS
    timed = {"decode_time_s", "decode_steps_per_s"}
    assert {k: v for k, v in off.items() if k not in timed} == \
        {k: v for k, v in on.items() if k not in timed}
    assert toks_off == toks_on and sw_off == sw_on
    assert off["decode_time_s"] > 0 and off["n_decode_steps"] > 0


def test_graph_replays_fold_into_launch_counts():
    before = ops.launch_counts()
    for _ in range(3):
        ops.count_replay((("decode_attention", 4),))
    ops.count_replay((("decode_attention", 2), ("flash_attention", 1)))
    got = ops.launch_counts()
    assert got["decode_attention"] == before["decode_attention"] + 14
    assert got["flash_attention"] == before["flash_attention"] + 1
    rest = {"lora_merge", "ssd_scan", "rglru_scan"}
    assert {k: got[k] for k in rest} == {k: before[k] for k in rest}
    ops.add_launch_counts({"decode_attention": 1})
    assert ops.launch_counts()["decode_attention"] == got[
        "decode_attention"] + 1
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}
