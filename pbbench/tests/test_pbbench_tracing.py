"""The readers of the program's serving records (``metrics/prefill_ms.py``,
``prefill_pad_pct.py``, ``prefill_cache_gib.py``, ``decode_host_ms.py``),
which reach ``repro_torch.serving.tracing.TRACER``
through the program's module.

On fabricated records: only records whose ``clock`` is the ``t0`` of a
window step outside the traced sub-window count (the cache's largest
reads every record), and each reader returns None with no record or no
such module.  On the CPU at reduced sizes, a traced run prints them.  On
the card (``cuda``), each cell's engine served for a few seconds at full
size reads the transient prefill cache it is known to build and a decode
step longer than its host part.
"""
import sys
import time

import pytest

from pbb import manifest, runner, serve
from pbb.serve import StepRec, Window
from repro_torch.serving import tracing
from repro_torch.serving.tracing import DecodeRec, PrefillRec

MOD = "repro_torch.serving.tracing"
READERS = ["prefill_ms.chat", "prefill_pad_pct.chat", "prefill_cache_gib",
           "decode_host_ms.chat"]


def _ctx(steps, m=None):
    win = Window(60.0, {}, steps, [], 0, 0.0, 0)
    return runner.Ctx(m or {}, {}, 60.0, win, 1.0, 0, None)


@pytest.fixture
def tr(monkeypatch):
    """A fresh tracer where the readers look for the program's."""
    t = tracing.Tracer()
    monkeypatch.setattr(tracing, "TRACER", t)
    return t


@pytest.fixture
def served():
    """The program's own tracer, emptied: what a run of one cell reads."""
    tracing.TRACER.clear()
    yield tracing.TRACER
    tracing.TRACER.clear()


def _fabricated(tr):
    """Window steps at 1.5 and 3.5 (untraced) and 2.5 (traced); records
    also from set-up (clock None, and 0.0 for a backlog's first step)."""
    steps = [StepRec(1.5, 1.6, 0.004), StepRec(2.5, 2.6, 0.004, traced=True),
             StepRec(3.5, 3.6, 0.004)]
    G = 2 ** 30
    tr.prefill.extend([
        PrefillRec(None, 32, 2048, 100, 1, "single", 12 * G, 0.9),
        PrefillRec(0.0, 32, 512, 300, 2, "single", 3 * G, 0.5),
        PrefillRec(1.5, 32, 512, 400, 1, "single", 3 * G, 0.2),
        PrefillRec(2.5, 32, 1024, 500, 2, "single", 6 * G, 0.7),
        PrefillRec(3.5, 32, 256, 112, 1, "single", 1 * G, 0.1)])
    tr.decode.extend([
        DecodeRec(0.0, 4, 0.5, 0.5, 0.5, 0.5),
        DecodeRec(1.5, 4, 0.0001, 0.0006, 0.004, 0.0002),
        DecodeRec(2.5, 4, 0.1, 0.1, 0.1, 0.1),
        DecodeRec(3.5, 4, 0.0003, 0.0008, 0.004, 0.0004)])
    return _ctx(steps)


def test_readers_count_the_untraced_window_steps_only(tr):
    ctx = _fabricated(tr)
    got = {n: manifest.reader(n)(ctx) for n in READERS}
    assert got["prefill_ms.chat"] == pytest.approx(1e3 * (0.2 + 0.1) / 2)
    assert got["prefill_pad_pct.chat"] == pytest.approx(
        100 * (1 - 512 / (32 * 512 + 32 * 256)))
    assert got["prefill_cache_gib"] == 12.0      # set-up's bucket counts
    assert got["decode_host_ms.chat"] == pytest.approx(0.5)
    # the .batch names read the same files
    assert manifest.reader("prefill_ms.batch")(ctx) == got["prefill_ms.chat"]


@pytest.mark.parametrize("name", READERS)
def test_no_record_reads_none(tr, name, monkeypatch):
    ctx = _ctx([StepRec(1.5, 1.6, 0.004)])
    assert manifest.reader(name)(ctx) is None
    tr.prefill.append(PrefillRec(9.0, 1, 64, 64, 1, "single", 1, 0.1))
    tr.decode.append(DecodeRec(9.0, 1, 0.1, 0.1, 0.1, 0.1))
    if name != "prefill_cache_gib":        # none made in the window
        assert manifest.reader(name)(ctx) is None
    monkeypatch.delitem(sys.modules, MOD)  # a program without the records
    assert manifest.reader(name)(ctx) is None


def _expected_cache_gib(m, rows):
    hd = m["head_dim"] or m["d_model"] // m["n_heads"]
    item = 4 if m["dtype"] == "float32" else 2
    kv = (2 * m["n_layers"] * rows * m["serving"]["max_len"]
          * m["n_kv_heads"] * hd * item)
    return (kv + 4 * rows) / 2 ** 30            # K, V and ``pos``


@pytest.mark.parametrize("cell,rows", [("opt-lora-chat", "slots"),
                                       ("moe-decode-batch", 1)])
def test_a_traced_cpu_run_prints_the_new_metrics(cell, rows, served):
    from test_pbbench_check import tiny
    bench, m, spec = tiny(cell)
    mets = manifest.cell_metrics(bench, cell, True)
    res = runner.run_cell(cell, m, spec, mets, 20240531, 2.5, True, "cpu",
                          time.perf_counter())
    assert res["correct"]
    got = res["metrics"]
    rows = m["serving"]["n_slots"] if rows == "slots" else rows
    assert got["prefill_cache_gib"]["value"] == pytest.approx(
        _expected_cache_gib(m, rows), rel=1e-12)
    suffix = "chat" if cell == "opt-lora-chat" else "batch"
    assert f"decode_host_ms.{suffix}" in got
    if suffix == "chat":
        assert {"prefill_ms.chat", "prefill_pad_pct.chat"} <= set(got)
        assert 0 < got["prefill_pad_pct.chat"]["value"] < 100
    assert {s.name for s in served.spans} >= {
        "engine.step", "batcher.decode.launch"}    # the traced tail's


CARD = {"opt-lora-chat": 12.0, "moe-decode-batch": 0.421875}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(CARD))
def test_the_card_reads_the_known_prefill_cache(cell, card, served):
    w = manifest.cell(manifest.load_benchmark(), cell)
    m, spec = manifest.config(w["config"]), manifest.traffic(w["traffic"])
    seconds = 6.0
    srv, due, queued = serve.prepare(m, spec, 2 ** 31 + 27, seconds, card)
    win = serve.run_window(srv, due, seconds, queued)
    serve.release(srv)
    ctx = runner.Ctx(m, spec, seconds, win, 0.0, 0, None)
    suffix = "chat" if cell == "opt-lora-chat" else "batch"
    got = {n: manifest.reader(n)(ctx) for n in (
        "prefill_cache_gib", f"decode_host_ms.{suffix}",
        f"decode_step_ms.{suffix}",
        "prefill_ms.chat", "prefill_pad_pct.chat", "admit_ms.chat")}
    print(f"{cell}: " + ", ".join(f"{k} {v!r}" for k, v in got.items()))
    assert got["prefill_cache_gib"] == pytest.approx(CARD[cell], abs=0.01)
    assert got[f"decode_host_ms.{suffix}"] < got[f"decode_step_ms.{suffix}"]
