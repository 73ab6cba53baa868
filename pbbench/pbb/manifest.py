"""``BENCHMARK.json`` and the data files it names.

A cell (``workloads`` entry) names a configuration and a traffic mix; the
harness finds ``configs/<config>.json`` and ``workloads/<traffic>.json``
by those names, and a per-layer metric's reader as
``metrics/<metric>.py``, else ``metrics/<metric up to its first dot>.py``
(one reader for ``decode_step_ms.chat`` and ``decode_step_ms.batch``).
Adding a cell, a configuration or a metric is adding files and entries.

A configuration is data plus its reference module.  The data,
``configs/<name>.json``, holds the model as it is run: its sizes, its
serving dtype, its slots and cache, and under ``reference`` the name of
a module ``reference/<reference>.py``.  That module holds the model's
equations in plain PyTorch (``reference/__init__.py`` names the functions
the correctness check calls) and states the facts that follow from the
model's layer structure, by three hooks:

* ``leaf_specs(m)``: every weight leaf as ``(path, shape, init)`` or
  ``(path, shape, init, dtype)``, in the order of draws
  (``weights.make_params`` says what each init means);
* ``decode_step_cost(m, n_live, cached_rows, routed_read)``: (operations,
  bytes) one decode step needs at least (``costs.decode_step_cost``'s
  contract);
* ``attn_layers(m)``: how many layers attend and hold K/V rows.

A module whose model is the default attention stack (``n_layers`` layers
of attention, each followed by a dense MLP or a mixture of experts, as
``reference/decoder.py`` computes it) defines none of them, and the
harness runs its own code for that stack.  A module whose model is not
that stack defines all three; one that defines only some is refused.  So
a model with another layout is added as new files: its configuration,
its reference module, its traffic and the entries that name them.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")

HOOKS = ("leaf_specs", "decode_step_cost", "attn_layers")


def load_benchmark(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json "
                     f"(have {[w['name'] for w in bench['workloads']]})")


def _load_json(kind: str, name: str) -> Dict:
    if not NAME_RE.match(name):
        raise SystemExit(f"bad {kind} name {name!r}")
    path = BENCH_DIR / kind / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def config(name: str) -> Dict:
    """``configs/<name>.json``: the model as it is run."""
    return _load_json("configs", name)


def traffic(name: str) -> Dict:
    """``workloads/<name>.json``: the traffic mix's parameters."""
    return _load_json("workloads", name)


def reference(m: Dict):
    """The configuration's reference module, ``reference/<reference>.py``."""
    return importlib.import_module(f"reference.{m['reference']}")


def layout_hook(m: Dict, name: str) -> Optional[Callable]:
    """The reference module's hook ``name`` (one of ``HOOKS``), or None
    where the module is of the default attention stack and defines none."""
    mod = reference(m)
    have = [h for h in HOOKS if hasattr(mod, h)]
    if have and len(have) < len(HOOKS):
        raise SystemExit(
            f"reference/{m['reference']}.py defines {have} of the layout "
            f"hooks {list(HOOKS)}: a layout other than the attention stack "
            f"states all three")
    return getattr(mod, name, None)


def applies(metric: Dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def cell_metrics(bench: Dict, cell_name: str, trace: bool) -> List[Dict]:
    """The metrics one run of ``cell_name`` prints: the end-to-end ones with
    ``trace`` off, the per-layer ones with it on.  A per-layer metric with
    no ``workloads`` key goes with every cell that reports the end-to-end
    metric it moves."""
    e2e = [m for m in bench["end_to_end"] if applies(m, cell_name)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def reader(metric_name: str) -> Callable:
    """The ``read(ctx)`` function of a per-layer metric."""
    for stem in (metric_name, metric_name.split(".")[0]):
        path = BENCH_DIR / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"pbb_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise SystemExit(f"no reader for metric {metric_name!r} under "
                     f"{BENCH_DIR / 'metrics'}")


def check_names(bench: Dict) -> List[str]:
    """Names and units outside the allowed characters (empty if none)."""
    bad: List[str] = []
    for c in bench["configs"]:
        bad += [c["name"]] if not NAME_RE.match(c["name"]) else []
        bad += [k for k in c.get("reduced", []) if not NAME_RE.match(k)]
    for w in bench["workloads"]:
        bad += [x for x in (w["name"], w["config"], w["traffic"])
                if not NAME_RE.match(x)]
    for m in bench["end_to_end"] + bench["per_layer"]:
        bad += [m["name"]] if not NAME_RE.match(m["name"]) else []
        bad += [m["unit"]] if not UNIT_RE.match(m["unit"]) else []
    return bad

