"""The port's examples (``examples/torch_*.py``) run on the CPU with
``--device cpu`` in a subprocess, exit 0 and print their equalities as
true."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# example -> (extra arguments, [(line marker, lines expected)]); the
# train driver takes its own smaller --steps
EXAMPLES = {
    "torch_quickstart": ([], [("partial-load tokens == full-load tokens: ",
                               1), ("tokens still equal: ", 1)]),
    "torch_recovery_drill": ([], [("exact=", 4)]),
    "torch_serve_lora": ([], [("every request served its 5 tokens: ", 1)]),
    "torch_train_e2e": (["--steps", "20", "--ckpt-every", "5"],
                        [("uninterrupted losses (rel 1e-5): ", 1)]),
}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs_on_cpu(name):
    extra, marks = EXAMPLES[name]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"{name}.py"), "--device",
         "cpu"] + extra, env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    for mark, n in marks:
        hit = [ln for ln in lines if mark in ln]
        assert len(hit) == n and all(mark + "True" in ln for ln in hit), hit
