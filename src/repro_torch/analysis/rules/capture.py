"""R4 — graph-capture hazards.

The port captures its decode step once as a CUDA graph (the batcher's
``_decode_sample``, captured by ``_capture``) and replays it every later
step.  A capture records launches, not Python: what the captured code
does on the host happens once, at capture time, and a replay repeats
only the recorded kernels on the recorded buffers.  So in code reached
from the body of a ``with torch.cuda.graph(...)`` block:

* a **host sync** (``.item()``, ``.cpu()``, ``.numpy()``, ``.tolist()``,
  ``synchronize()``) fails the capture on the card, or, where it reads
  a value, freezes the capture-time value into every replay;
* a **fresh allocation kept past the capture** (``self.x =
  torch.zeros(...)``, ``self.x = y.clone()``) lives in the graph's
  private memory pool, is rewritten by every replay, and is not the
  buffer a later eager step would write;
* a **shape that depends on the data** (``nonzero``, ``unique``,
  ``masked_select``, ``argwhere``, boolean-mask indexing) needs the
  host to learn the size, so it syncs, and the replay keeps the
  capture-time shape whatever the data then holds.

A **capture built inside a loop** records and instantiates a fresh graph
each iteration, unless it sits under a cache guard (an ``if`` testing
``is None`` or ``not in``, as the batcher's ``self._graph is None``).

The captured code is the block's body plus, transitively, the
``self.method`` bodies of its class that it calls.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set

from repro_torch.analysis.context import Module, binding_str, is_capture
from repro_torch.analysis.findings import Finding

_SYNCS = ("item", "cpu", "numpy", "tolist", "synchronize")
_DATA_SHAPES = ("nonzero", "unique", "unique_consecutive", "masked_select",
                "argwhere")
_FACTORIES = ("empty", "zeros", "ones", "full", "tensor", "arange",
              "empty_like", "zeros_like", "ones_like", "full_like", "rand",
              "randn", "randint", "clone", "as_tensor")


def _methods(module: Module) -> Dict[str, Dict[str, ast.AST]]:
    """class name -> method name -> def node."""
    out: Dict[str, Dict[str, ast.AST]] = {}
    for node in ast.walk(module.tree):
        if isinstance(node, ast.ClassDef):
            out[node.name] = {
                f.name: f for f in node.body
                if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))}
    return out


def _reached(module: Module, block: ast.AST) -> List[ast.AST]:
    """The block's statements and the bodies of the ``self.method``s of
    its class they call, transitively."""
    cls = module.qualname(block).split(".")[0]
    methods = _methods(module).get(cls, {})
    out: List[ast.AST] = list(block.body)
    seen: Set[str] = set()
    todo = list(block.body)
    while todo:
        node = todo.pop()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and isinstance(sub.func,
                                                        ast.Attribute) \
                    and isinstance(sub.func.value, ast.Name) \
                    and sub.func.value.id == "self" \
                    and sub.func.attr in methods \
                    and sub.func.attr not in seen:
                seen.add(sub.func.attr)
                fn = methods[sub.func.attr]
                out.append(fn)
                todo.append(fn)
    return out


def _mask_names(root: ast.AST) -> Set[str]:
    """Names assigned a comparison, a boolean combination or a negation
    (boolean masks) under ``root``."""
    out: Set[str] = set()
    for node in ast.walk(root):
        if isinstance(node, ast.Assign) and _is_mask(node.value, set()):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


def _is_mask(node: ast.AST, names: Set[str]) -> bool:
    if isinstance(node, (ast.Compare, ast.BoolOp)):
        return True
    if isinstance(node, ast.UnaryOp) and isinstance(node.op,
                                                    (ast.Invert, ast.Not)):
        return True
    if isinstance(node, ast.BinOp) and isinstance(node.op,
                                                  (ast.BitAnd, ast.BitOr)):
        return _is_mask(node.left, names) or _is_mask(node.right, names)
    return isinstance(node, ast.Name) and node.id in names


def _check_captured(module: Module, root: ast.AST, flag) -> None:
    masks = _mask_names(root)
    for node in ast.walk(root):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            name = node.func.attr
            if name in _SYNCS and not (name == "item" and node.args):
                flag(node, f"capture-sync:{name}",
                     f"`{name}()` in captured code: a host sync fails the "
                     "capture, and a value it reads is frozen into every "
                     "replay")
            elif name in _DATA_SHAPES:
                flag(node, f"capture-data-shape:{name}",
                     f"`{name}` in captured code: its shape depends on the "
                     "data, which the host must read; the replay keeps the "
                     "capture-time shape")
        elif isinstance(node, ast.Subscript) and _is_mask(node.slice,
                                                           masks):
            flag(node, "capture-data-shape:mask-index",
                 "boolean-mask indexing in captured code: the result's "
                 "length depends on the data — use torch.where over a "
                 "static shape")
        elif isinstance(node, ast.Assign):
            v = node.value
            fresh = isinstance(v, ast.Call) and isinstance(
                v.func, ast.Attribute) and v.func.attr in _FACTORIES
            for t in node.targets:
                key = binding_str(t)
                if fresh and key is not None and key.startswith("self."):
                    flag(node, f"capture-alloc:{key}",
                         f"`{key}` keeps a tensor allocated in captured "
                         "code: it lives in the graph's pool and every "
                         "replay rewrites it — allocate it before the "
                         "capture and write into it")


def _guarded(loop: ast.AST, target: ast.AST) -> bool:
    """Is ``target`` under an ``if`` in ``loop`` testing ``is None`` or
    ``not in`` (a cache guard)?"""
    for node in ast.walk(loop):
        if isinstance(node, ast.If) and any(
                target is sub for stmt in node.body
                for sub in ast.walk(stmt)):
            for sub in ast.walk(node.test):
                if isinstance(sub, ast.Compare) and any(
                        isinstance(op, (ast.Is, ast.NotIn))
                        for op in sub.ops):
                    return True
    return False


def check(module: Module, config) -> List[Finding]:
    """Flag capture hazards in captured code and captures in loops."""
    findings: List[Finding] = []
    seen = set()

    def flag(node, detail, msg):
        key = (node.lineno, node.col_offset, detail)
        if key not in seen:
            seen.add(key)
            findings.append(Finding("R4", module.path, node.lineno,
                                    node.col_offset, module.qualname(node),
                                    detail, msg))

    for block in module.captures:
        for root in _reached(module, block):
            _check_captured(module, root, flag)

    for loop in ast.walk(module.tree):
        if not isinstance(loop, (ast.For, ast.While, ast.AsyncFor)):
            continue
        for stmt in loop.body + getattr(loop, "orelse", []):
            for node in ast.walk(stmt):
                made = (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "CUDAGraph") \
                    or is_capture(node)
                if made and not _guarded(loop, node):
                    flag(node, "capture-in-loop",
                         "a CUDA graph captured inside a loop: every "
                         "iteration records and instantiates a fresh "
                         "graph — capture once, or cache by shape under "
                         "an `is None`/`not in` guard")
    return findings
