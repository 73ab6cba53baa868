"""R2 — host syncs inside the decode/prefill hot-path modules.

The steady-state contract of the port's batcher is ONE device->host
transfer per decode step — the sampled ``(B,)`` tokens, read once from
the replayed graph's static output — and one per admission.  Anything
else that waits for the card (``.item()``, ``.cpu()``, ``.numpy()``,
``torch.cuda.synchronize()``, an event's or a stream's
``.synchronize()``, ``float()``/``int()``/``.tolist()``/``np.asarray``
of a device tensor) stalls the host that issues the launches: on the
card a step is a graph replay of a few milliseconds, and a sync in its
loop costs a whole step of idle device.  No CPU test catches it.

Scope: only modules matching ``config.hot_paths`` (the serving engine,
``models/``, ``kernels/``).  ``.item()``, ``.cpu()``, ``.numpy()`` and
``synchronize`` are flagged wherever they appear — there is no
host-side reading of those.  To keep the rule quiet on legitimate host
work (numpy batch assembly at admission, metadata such as strides),
``np.asarray``/``np.array``/``float``/``int``/``.tolist()`` are flagged
only when their operand is *device-origin*: a call into ``torch`` or
the port's model and kernel modules, a private ``self._*`` method, a
chain on such a call, or a name most recently assigned (lexically) from
one in the same function.  The designed transfer points carry inline
suppressions naming themselves as such, which doubles as documentation
of where the hot path touches the host.
"""
from __future__ import annotations

import ast
from typing import Dict, List

from repro_torch.analysis.context import Module
from repro_torch.analysis.findings import Finding

# modules whose calls return tensors on the model's device
_DEVICE_ORIGIN_MODULES = ("torch", "F", "ops", "transformer", "attn_lib",
                          "moe", "mamba2", "rglru")
_ALWAYS = {"item": "`.item()` forces a device->host sync of a scalar — "
                   "batch it with the step's one designed transfer",
           "cpu": "`.cpu()` copies to the host and waits for the card — "
                  "not in the hot path but at a designed transfer point",
           "numpy": "`.numpy()` needs host memory: on a device tensor it "
                    "is a sync and a copy",
           "synchronize": "`synchronize()` stalls the issuing host until "
                          "the card drains — only measurements may"}


def _is_device_call(node: ast.AST) -> bool:
    """Heuristic: does this expression produce a device tensor?"""
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute):
            base = f.value
            # self._decode(...): the batcher's private device steps
            if isinstance(base, ast.Name) and base.id == "self" \
                    and f.attr.startswith("_"):
                return True
            # torch.foo(...), F.foo(...), ops.foo(...); chains X(...).to()
            if isinstance(base, ast.Name) \
                    and base.id in _DEVICE_ORIGIN_MODULES:
                return True
            if isinstance(base, ast.Call):
                return _is_device_call(base)
    return False


def _device_names_at(fn: ast.AST) -> Dict[str, Dict[str, List[int]]]:
    """name -> sorted lines where it is assigned a device-origin value
    ("dev") or another value ("host")."""
    dev: Dict[str, List[int]] = {}
    host: Dict[str, List[int]] = {}
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        is_dev = _is_device_call(node.value)
        for t in node.targets:
            names = [t] if isinstance(t, ast.Name) else [
                e for e in ast.walk(t)
                if isinstance(e, ast.Name) and e.id != "self"]
            for n in names:
                (dev if is_dev else host).setdefault(
                    n.id, []).append(n.lineno)
    return {"dev": dev, "host": host}


def _origin_is_device(name: str, line: int, table) -> bool:
    """Was ``name``'s most recent (lexical) assignment device-origin?"""
    last_dev = max([ln for ln in table["dev"].get(name, []) if ln <= line],
                   default=None)
    if last_dev is None:
        return False
    last_host = max([ln for ln in table["host"].get(name, [])
                     if ln <= line], default=-1)
    return last_dev > last_host


def _base_name(node: ast.AST):
    """Peel subscripts/attributes down to the underlying Name."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _device_operand(node: ast.AST, line: int, table) -> bool:
    name = _base_name(node)
    return _is_device_call(node) or (
        name is not None and _origin_is_device(name, line, table))


def check(module: Module, config) -> List[Finding]:
    """Flag device->host synchronization points in hot-path modules."""
    if not module.matches(config.hot_paths):
        return []
    findings: List[Finding] = []

    def flag(node, detail, msg):
        findings.append(Finding("R2", module.path, node.lineno,
                                node.col_offset, module.qualname(node),
                                detail, msg))

    fns = [n for n in ast.walk(module.tree)
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    seen = set()
    for fn in fns:
        table = _device_names_at(fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call) or id(node) in seen:
                continue
            seen.add(id(node))
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _ALWAYS \
                    and not (f.attr == "item" and node.args):
                flag(node, f"call:{f.attr}", _ALWAYS[f.attr])
            elif _sync_wrapper(f) and node.args \
                    and _device_operand(node.args[0], node.lineno, table):
                what = _sync_wrapper(f)
                flag(node, f"call:{what}",
                     f"`{what}(...)` of a device tensor is a device->host "
                     "sync — keep it on the card or fold it into the one "
                     "designed transfer per step")
            elif isinstance(f, ast.Attribute) and f.attr == "tolist" \
                    and _device_operand(f.value, node.lineno, table):
                flag(node, "call:tolist", "`.tolist()` of a device tensor "
                     "syncs and boxes every element — transfer once at "
                     "the designed point")
    return findings


def _sync_wrapper(f: ast.AST):
    """Name of a host-materializing wrapper call, or None."""
    if isinstance(f, ast.Attribute) and f.attr in ("asarray", "array") \
            and isinstance(f.value, ast.Name) and f.value.id == "np":
        return f"np.{f.attr}"
    if isinstance(f, ast.Name) and f.id in ("float", "int"):
        return f.id
    return None
