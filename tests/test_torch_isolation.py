"""The port stands alone: importing ``repro_torch`` and every submodule
loads neither JAX nor anything of the JAX package ``repro``, and no source
of the port (nor ``chip_smoke.py``, ``tools/pbcheck_torch.py`` or an
``examples/torch_*.py``) names them in an import."""
import ast
import os
import re
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


# a private name of ``transformer``, or the Mamba-2 block without the rest
# of its layer, named outside ``models/`` (as an attribute or an import)
_SEAM = re.compile(r"\btransformer\._|\bmamba2\.ssm_block_(fwd|step)\b"
                   r"|models\.transformer import [^#]*\b_\w"
                   r"|models\.mamba2 import [^#]*\bssm_block_(fwd|step)\b")


def test_only_models_reach_behind_the_layer_seam():
    """No module of the port outside ``models/`` names a ``_``-prefixed
    helper of ``transformer``, ``mamba2.ssm_block_fwd`` or
    ``mamba2.ssm_block_step``: recovery, the pipeline belt, the dry run
    and the rest walk the layers through ``transformer.layers`` and run
    them through ``transformer.layer_fwd``, so a model's layer is written
    once."""
    bad = []
    for path in sorted(PORT.rglob("*.py")):
        if path.relative_to(PORT).parts[0] == "models":
            continue
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if _SEAM.search(line):
                bad.append(f"{path.relative_to(ROOT)}:{n}: {line.strip()}")
    assert not bad, "\n".join(bad)
