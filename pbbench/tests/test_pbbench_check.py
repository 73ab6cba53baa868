"""The correctness check on the CPU at reduced sizes: the reference agrees
with the program's served tokens, and each fault the serving cells can
have, planted under the timed path, turns ``correct`` false.

A reduced configuration keeps the cell's structure (bucketed prefill into
slots, the decode step over the cache, adapters switched by epochs; for
the MoE, capacity prefill and dropless decode) at widths the CPU runs in
seconds, in float32, where the program's gap to the float32 reference is
rounding alone (the limit here, 1e-3, is for that precision; the cells'
limits are set on the card, PERF.md).  The faults are those of ``faults.py``: a token altered where it is
produced, a decode step that returns its state unchanged, half of the
batch left out.  The exchange between chips is no fault these cells can have: each runs on
one card.
"""
import time

import pytest
import torch

import faults
from pbb import check, manifest, runner, serve

LIMIT = 1e-3


def tiny(cell: str, dtype: str = "float32"):
    bench = manifest.load_benchmark()
    w = manifest.cell(bench, cell)
    m = manifest.config(w["config"])
    spec = manifest.traffic(w["traffic"])
    m.update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
             d_ff=128, vocab_size=257, dtype=dtype)
    if m.get("n_experts"):
        m.update(n_experts=8, top_k=2, n_shared_experts=2, moe_d_ff=32,
                 d_ff=32)
        m["serving"] = {"n_slots": 4, "max_len": 160,
                        "policy": {"epoch_budget": 4, "max_batch": 4}}
        spec.update(arrivals={"kind": "backlog", "requests": 12},
                    prompt_len={"dist": "uniform", "min": 8, "max": 40},
                    output_len={"dist": "uniform", "min": 20, "max": 60})
    else:
        m["serving"] = {"n_slots": 4, "max_len": 128,
                        "policy": {"epoch_budget": 4, "max_batch": 4}}
        spec.update(arrivals={"kind": "gamma", "rate": 8.0, "cv2": 2.0},
                    prompt_len={"dist": "lognormal", "median": 24,
                                "sigma": 0.8, "min": 4, "max": 60},
                    output_len={"dist": "lognormal", "median": 12,
                                "sigma": 0.7, "min": 4, "max": 40},
                    adapters={"base": 0.5, "lora0": 0.3, "lora1": 0.2})
    spec["check"] = dict(spec["check"], limits={
        k: LIMIT for k in spec["check"]["limits"]})
    return bench, m, spec


def run(cell: str, seed: int = 20240531, dtype: str = "float32",
        trace: bool = False):
    bench, m, spec = tiny(cell, dtype)
    mets = manifest.cell_metrics(bench, cell, trace)
    return runner.run_cell(cell, m, spec, mets, seed, 2.5, trace, "cpu",
                           time.perf_counter())


CELLS = ["opt-lora-chat", "moe-decode-batch"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_agrees_with_the_port(cell):
    res = run(cell)
    assert res["correct"], res["checks"]
    assert res["checks"]["requests_checked"]["value"] >= 3
    assert list(res)[-1] == "checks"


def test_traced_run_reports_its_per_layer_metrics():
    res = run("opt-lora-chat", trace=True)
    assert res["correct"]
    assert res["device"]["window_s"] > 0
    assert {"admit_ms.chat", "decode_step_ms.chat", "decode_mfu.chat",
            "device_idle_pct.chat", "occupancy.chat",
            "kv_live_peak_gib"} <= set(res["metrics"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [faults.altered_token,
                                   faults.state_unchanged,
                                   faults.half_batch])
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault,
                                                      monkeypatch):
    fault(monkeypatch)
    res = run(cell)
    assert not res["correct"], res["checks"]


def test_the_control_reads_above_the_served_bf16():
    bench, m, spec = tiny("opt-lora-chat", "bfloat16")
    srv, due, queued = serve.prepare(m, spec, 5, 2.5, "cpu")
    win = serve.run_window(srv, due, 2.5, queued)
    serve.release(srv)
    got = check.judge_run(srv, win.finished, 5, spec, control=True)
    assert got["control_gap_max"] > got["gap_max"]
    assert got["control_request_gap_mean_max"] > got["request_gap_mean_max"]


def test_the_largest_request_mean_gap_sees_one_request_alone():
    """One request's tokens far off the reference move the largest of the
    requests' mean gaps by their own mean, where the pooled mean spreads
    them over the whole sample."""
    bench, m, spec = tiny("moe-decode-batch")
    srv, due, queued = serve.prepare(m, spec, 9, 2.5, "cpu")
    win = serve.run_window(srv, due, 2.5, queued)
    serve.release(srv)
    items = check.sample(win.finished, 9, 15)
    assert len(items) >= 4
    req, served = items[0]
    bad = [(req, [(t + 1) % m["vocab_size"] for t in served])] + items[1:]
    got = check.judge(m, srv.params, srv.loras, bad, "cpu")
    ok = check.judge(m, srv.params, srv.loras, items, "cpu")
    assert ok["request_gap_mean_max"] <= LIMIT
    assert got["request_gap_mean_max"] > LIMIT
    assert got["request_gap_mean_max"] > 2 * got["gap_mean"]
