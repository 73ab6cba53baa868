"""granite-rag-batch's own planted faults on the card, at the cell's full
size and load: each makes the program serve another model than the
configuration states, and the check's verdict must come out not correct.

    python -m pytest -q -s pbbench/tests/test_pbbench_granite_card.py

* ``residual multiplier 1``: each sublayer added to the residual unscaled;
* ``RoPE on``: rotary positions (theta 1e4) on q and k of the attention
  layers;
* ``shared MLP left out``: the experts' sum without the shared MLP.

(``test_pbbench_card.py`` covers the cell's control and the faults every
cell shares.)"""
import dataclasses

import pytest

from pbb import check, manifest, serve

CELL = "granite-rag-batch"
SEED = 2 ** 31 + 404


def _config_fault(**over):
    def plant(monkeypatch):
        orig = serve.program_config
        monkeypatch.setattr(serve, "program_config", lambda m: dataclasses
                            .replace(orig(m), **over))
    return plant


def _no_shared(monkeypatch):
    from repro_torch.models import moe
    monkeypatch.setattr(moe, "_shared", lambda p, xt, act, y: y)


FAULTS = {"residual multiplier 1": _config_fault(residual_multiplier=1.0),
          "RoPE on": _config_fault(use_rope=True),
          "shared MLP left out": _no_shared}


def _serve(m, spec, card):
    """The check's numbers of one window; the replica and its weights are
    freed when this returns, so a failed case leaves none to the next."""
    srv, due, queued = serve.prepare(m, spec, SEED, 45.0, card)
    win = serve.run_window(srv, due, 45.0, queued)
    serve.release(srv)
    return check.judge_run(srv, win.finished, SEED, spec)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_hybrid_fault_is_not_correct(fault, card, monkeypatch):
    w = manifest.cell(manifest.load_benchmark(), CELL)
    m, spec = manifest.config(w["config"]), manifest.traffic(w["traffic"])
    FAULTS[fault](monkeypatch)
    got = _serve(m, spec, card)
    checks, correct = check.verdict(got, spec)
    print(f"{CELL} {fault} seed {SEED}: " + ", ".join(
        f"{k} {v['value']!r}" for k, v in checks.items()))
    assert not correct, checks
