"""The port stands alone: importing ``repro_torch`` and every submodule
loads neither JAX nor anything of the JAX package ``repro``, and no source
of the port (nor ``chip_smoke.py``, ``tools/pbcheck_torch.py`` or an
``examples/torch_*.py``) names them in an import."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "tools" / "pbcheck_torch.py"]
           + sorted((ROOT / "examples").glob("torch_*.py")))

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
print(" ".join(names))
sys.exit(1 if bad else 0)
"""


def test_import_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 20
    walked = out.stdout.splitlines()[-1].split()
    for name in ("distributed.pipeline", "distributed.context",
                 "distributed.shardings", "launch.mesh", "launch.train",
                 "training.optimizer", "training.train", "training.data",
                 "training.checkpoint", "launch.dryrun", "launch.rooflines",
                 "analysis", "analysis.cli", "analysis.context",
                 "analysis.rules.replay", "analysis.rules.hostsync",
                 "analysis.rules.capture", "analysis.rules.locks",
                 "analysis.rules.chaos", "analysis.rules.docstrings"):
        assert "repro_torch." + name in walked, name


def _banned(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_neither_jax_nor_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_banned(n) for n in names), \
            f"{path.name}:{node.lineno} imports {names}"
