"""R3 — lock discipline for fill-thread-shared engine state.

``PipeBoostEngine.start_fill`` runs ``load_round`` on a daemon thread
concurrently with serving calls on the main thread (the overlap of
loading and serving is the paper's core latency win).  Every attribute
that thread touches is therefore shared mutable state, and the engine's
contract is that ALL access to it goes through ``with
self._load_lock``: a crash racing the fill thread's accounting is
exactly the bug such a violation makes, found late, at runtime.

The model, recovered statically per class:

1. **Locks**: ``self.X = threading.Lock()/RLock()`` attributes.
2. **Thread entry points**: functions passed as ``target=`` to
   ``threading.Thread`` (including closures), plus the transitive
   closure of ``self.method`` calls/reads they make within the class
   (property reads traverse too — ``self.ready`` runs code).
3. **Shared set G**: plain data attributes the thread closure touches,
   minus the locks themselves and ``threading`` primitives (Events and
   Threads are internally synchronized), minus attributes never
   written outside ``__init__`` (immutable config can be read racily).
4. **Violation**: any read or write of an attribute in G, anywhere in
   the class outside ``__init__``, that is not lexically inside a
   ``with self.<lock>`` block.

Writes include mutating calls (``self.rounds.append(...)``) and
subscript/augmented assignment, not just rebinding.  Classes with no
lock or no thread entry points are skipped entirely, so the rule stays
silent on the (single-threaded) serving and cluster layers.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from repro_torch.analysis.context import Module
from repro_torch.analysis.findings import Finding

_MUTATORS = ("append", "add", "extend", "update", "pop", "remove",
             "discard", "clear", "insert", "setdefault", "popitem")
_THREADING_SAFE = ("Event", "Thread", "Condition", "Semaphore",
                   "BoundedSemaphore", "Barrier")
_LOCK_TYPES = ("Lock", "RLock")


def _threading_ctor(node: ast.AST, names: tuple) -> bool:
    """Is ``node`` a call of ``threading.X()`` / bare ``X()``, X in names."""
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
            and f.value.id == "threading" and f.attr in names:
        return True
    return isinstance(f, ast.Name) and f.id in names


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


class _ClassModel:
    """Thread/lock model of one class (see module docstring)."""

    def __init__(self, cls: ast.ClassDef):
        self.cls = cls
        self.methods: Dict[str, ast.FunctionDef] = {
            n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        self.locks: Set[str] = set()
        self.safe_attrs: Set[str] = set()
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                attr = _self_attr(node.targets[0])
                if attr is None:
                    continue
                if _threading_ctor(node.value, _LOCK_TYPES):
                    self.locks.add(attr)
                elif _threading_ctor(node.value, _THREADING_SAFE):
                    self.safe_attrs.add(attr)
        self.entries = self._thread_entries()
        self.shared = self._shared_attrs() if self.entries else set()

    # -- step 2: thread entry closure -----------------------------------
    def _thread_entries(self) -> List[ast.FunctionDef]:
        roots: List[ast.FunctionDef] = []
        for node in ast.walk(self.cls):
            if not (isinstance(node, ast.Call)
                    and _threading_ctor(node, ("Thread",))):
                continue
            for kw in node.keywords:
                if kw.arg != "target":
                    continue
                attr = _self_attr(kw.value)
                if attr is not None and attr in self.methods:
                    roots.append(self.methods[attr])
                elif isinstance(kw.value, ast.Name):
                    # a closure defined in some enclosing method
                    for fn in ast.walk(self.cls):
                        if isinstance(fn, ast.FunctionDef) \
                                and fn.name == kw.value.id:
                            roots.append(fn)
        # transitive closure over self.<method> references
        seen = {id(r) for r in roots}
        work = list(roots)
        while work:
            fn = work.pop()
            for node in ast.walk(fn):
                attr = _self_attr(node)
                if attr in self.methods \
                        and id(self.methods[attr]) not in seen:
                    seen.add(id(self.methods[attr]))
                    roots.append(self.methods[attr])
                    work.append(self.methods[attr])
        return roots

    # -- step 3: the shared attribute set G -----------------------------
    def _shared_attrs(self) -> Set[str]:
        touched: Set[str] = set()
        for fn in self.entries:
            for node in ast.walk(fn):
                attr = _self_attr(node)
                if attr is None or attr in self.methods \
                        or attr in self.locks or attr in self.safe_attrs:
                    continue
                touched.add(attr)
        # attrs never written outside __init__ are effectively frozen
        written: Set[str] = set()
        for name, fn in self.methods.items():
            if name == "__init__":
                continue
            written |= self._writes_in(fn)
        return touched & written

    def _writes_in(self, fn: ast.AST) -> Set[str]:
        out: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    out |= self._write_targets(t)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                out |= self._write_targets(node.target)
            elif isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr in _MUTATORS:
                    attr = _self_attr(f.value)
                    if attr is not None:
                        out.add(attr)
        return out

    def _write_targets(self, t: ast.AST) -> Set[str]:
        out: Set[str] = set()
        attr = _self_attr(t)
        if attr is not None:
            out.add(attr)
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                out |= self._write_targets(e)
        if isinstance(t, ast.Subscript):
            attr = _self_attr(t.value)
            if attr is not None:
                out.add(attr)
        return out


def _is_lock_with(item: ast.withitem, locks: Set[str]) -> bool:
    attr = _self_attr(item.context_expr)
    if attr in locks:
        return True
    # with self._load_lock.acquire_timeout(...) style wrappers
    ce = item.context_expr
    if isinstance(ce, ast.Call) and isinstance(ce.func, ast.Attribute):
        return _self_attr(ce.func.value) in locks
    return False


def _check_function(model: _ClassModel, fn: ast.FunctionDef,
                    module: Module, findings: List[Finding]) -> None:
    """Flag unguarded accesses to shared attrs inside one method."""

    def visit(node: ast.AST, locked: bool) -> None:
        if isinstance(node, ast.With):
            inner = locked or any(_is_lock_with(i, model.locks)
                                  for i in node.items)
            for item in node.items:
                visit(item, locked)
            for child in node.body:
                visit(child, inner)
            return
        attr = _self_attr(node)
        if attr is not None and attr in model.shared and not locked:
            findings.append(Finding(
                "R3", module.path, node.lineno, node.col_offset,
                module.qualname(node), f"attr:{attr}",
                f"`self.{attr}` is shared with the background fill "
                f"thread but accessed here outside `with self."
                f"{sorted(model.locks)[0]}`"))
            return          # one finding per access expression
        for child in ast.iter_child_nodes(node):
            visit(child, locked)

    for stmt in fn.body:
        visit(stmt, False)


def check(module: Module, config) -> List[Finding]:
    """Flag lock-discipline violations in thread-spawning classes."""
    findings: List[Finding] = []
    for cls in ast.walk(module.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        model = _ClassModel(cls)
        if not model.locks or not model.entries or not model.shared:
            continue
        for name, fn in model.methods.items():
            if name == "__init__":
                continue
            _check_function(model, fn, module, findings)
    return findings
