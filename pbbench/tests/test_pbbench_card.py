"""The control and planted faults of each cell on the card, at the cell's
own size and load.

    python -m pytest -q -s pbbench/tests/test_pbbench_card.py   # on the card

Every cell of ``BENCHMARK.json`` is covered, found by its entry.  On
each of three seeds the program's served tokens are within the cell's
limits and the tokens the fp8 control puts first are not; with a fault
planted under the timed path (``faults.py``: a token altered, half of the
batch left out) the check's verdict is not correct.  Each case prints its
readings (``-s``).
"""
import pytest

import faults
from pbb import check, manifest, serve

SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)
CELLS = [w["name"] for w in manifest.load_benchmark()["workloads"]]


def _cell(name):
    w = manifest.cell(manifest.load_benchmark(), name)
    spec = manifest.traffic(w["traffic"])
    # long enough to finish the mix's longest requests
    seconds = 45.0 if spec["arrivals"]["kind"] == "backlog" else 20.0
    return manifest.config(w["config"]), spec, seconds


def _serve(m, spec, seconds, seed, card, control=False):
    srv, due, queued = serve.prepare(m, spec, seed, seconds, card)
    win = serve.run_window(srv, due, seconds, queued)
    serve.release(srv)
    return check.judge_run(srv, win.finished, seed, spec, control=control)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell, card):
    m, spec, seconds = _cell(cell)
    for seed in SEEDS:
        got = _serve(m, spec, seconds, seed, card, control=True)
        for num, limit in spec["check"]["limits"].items():
            print(f"{cell} seed {seed}: {num} {got[num]!r}, control "
                  f"{got['control_' + num]!r}, limit {limit!r}")
        assert check.verdict(got, spec)[1], got
        ctl = {k[len("control_"):]: v for k, v in got.items()
               if k.startswith("control_")}
        assert not check.verdict(dict(got, **ctl), spec)[1], got


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [faults.altered_token, faults.half_batch])
def test_a_planted_fault_is_not_correct(cell, fault, card, monkeypatch):
    m, spec, seconds = _cell(cell)
    fault(monkeypatch)
    got = _serve(m, spec, seconds, SEEDS[0], card)
    checks, correct = check.verdict(got, spec)
    print(f"{cell} {fault.__name__} seed {SEEDS[0]}: " + ", ".join(
        f"{k} {v['value']!r}" for k, v in checks.items()))
    assert not correct, checks
