"""R5 — chaos-kind / recovery-mode exhaustiveness.

The seeded chaos harness promises that a fault script replays
identically under the tick and event engines.  That only holds if
every ``ChaosEvent`` kind the schedule can carry is actually handled
by the engines' shared dispatch — and vice versa: a handler branch for
a kind the schema doesn't define is dead code hiding a typo.  Same
shape for recovery modes: ``ClusterMetrics.on_recovery`` asserts its
mode vocabulary at runtime, but a misspelled literal at a call site
only explodes when that recovery path actually fires (i.e. during an
outage — the worst possible time).

This is a *project* rule: it reasons across every scanned module.

* **kinds**: the ``CHAOS_KINDS`` tuple is the schema; a module is a
  handler when it compares literals against an ``.kind`` attribute
  *and* at least one of those literals is a defined chaos kind (other
  layers use ``.kind`` for unrelated vocabularies — layer kinds like
  ``"prefill"``/``"decode"`` — and are out of scope).  Each handler
  must compare every defined kind (else: unhandled), and must not
  compare undefined literals (else: dead branch / typo).
* **modes**: the ``assert mode in (...)`` inside ``def on_recovery``
  is the schema; every ``*.on_recovery("<literal>", ...)`` call site
  must use a member of it.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.context import Module
from repro_torch.analysis.findings import Finding


def _literal_strs(node: ast.AST) -> Optional[Set[str]]:
    """Extract the string set of a Constant / Tuple-of-Constant node."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return {node.value}
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        out = set()
        for e in node.elts:
            if not (isinstance(e, ast.Constant)
                    and isinstance(e.value, str)):
                return None
            out.add(e.value)
        return out
    return None


def _find_kind_schema(modules) -> Optional[Tuple[str, Set[str]]]:
    """Locate ``CHAOS_KINDS = (...)`` -> (path, defined kinds)."""
    for m in modules:
        for node in ast.walk(m.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id == "CHAOS_KINDS":
                lits = _literal_strs(node.value)
                if lits:
                    return m.path, lits
    return None


def _kind_comparisons(module: Module) -> List[Tuple[ast.Compare, Set[str]]]:
    """Comparisons of an ``X.kind`` attribute against string literals."""
    out = []
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Compare) or len(node.comparators) != 1:
            continue
        sides = [node.left, node.comparators[0]]
        attr = next((s for s in sides if isinstance(s, ast.Attribute)
                     and s.attr == "kind"), None)
        lit = next((ls for s in sides
                    if (ls := _literal_strs(s)) is not None), None)
        if attr is not None and lit is not None:
            out.append((node, lit))
    return out


def _find_mode_schema(modules) -> Optional[Tuple[str, Set[str]]]:
    """``assert mode in (...)`` inside ``def on_recovery`` is the mode
    vocabulary."""
    for m in modules:
        for node in ast.walk(m.tree):
            if not (isinstance(node, ast.FunctionDef)
                    and node.name == "on_recovery"):
                continue
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assert) \
                        and isinstance(sub.test, ast.Compare) \
                        and isinstance(sub.test.ops[0], ast.In):
                    lits = _literal_strs(sub.test.comparators[0])
                    if lits:
                        return m.path, lits
    return None


def check_project(modules, config) -> List[Finding]:
    """Cross-module exhaustiveness findings (see module docstring)."""
    findings: List[Finding] = []

    kinds = _find_kind_schema(modules)
    if kinds is not None:
        schema_path, defined = kinds
        for m in modules:
            comps = _kind_comparisons(m)
            # Handler modules are those whose `.kind` literals overlap
            # the chaos vocabulary; `.kind` is also a layer-kind field
            # elsewhere ("prefill"/"decode"/...), which R5 must ignore.
            if not comps or not (
                    set().union(*(lits for _, lits in comps)) & defined):
                continue
            handled: Set[str] = set()
            first = comps[0][0]
            for node, lits in comps:
                handled |= lits
                unknown = lits - defined
                for u in sorted(unknown):
                    findings.append(Finding(
                        "R5", m.path, node.lineno, node.col_offset,
                        m.qualname(node), f"unknown-kind:{u}",
                        f"`.kind` compared against {u!r}, which is not "
                        f"in CHAOS_KINDS ({schema_path}) — dead branch "
                        f"or typo"))
            for missing in sorted(defined - handled):
                findings.append(Finding(
                    "R5", m.path, first.lineno, first.col_offset,
                    m.qualname(first), f"unhandled-kind:{missing}",
                    f"this module dispatches on `.kind` but never "
                    f"handles {missing!r} (defined in CHAOS_KINDS, "
                    f"{schema_path}) — tick/event replay would "
                    f"silently diverge on it"))

    modes = _find_mode_schema(modules)
    if modes is not None:
        schema_path, allowed = modes
        for m in modules:
            for node in ast.walk(m.tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "on_recovery"
                        and node.args):
                    continue
                a0 = node.args[0]
                if isinstance(a0, ast.Constant) \
                        and isinstance(a0.value, str) \
                        and a0.value not in allowed:
                    findings.append(Finding(
                        "R5", m.path, node.lineno, node.col_offset,
                        m.qualname(node), f"unknown-mode:{a0.value}",
                        f"on_recovery mode {a0.value!r} is not in the "
                        f"vocabulary asserted by on_recovery "
                        f"({schema_path}) — it would raise only when "
                        f"this recovery path fires"))
    return findings
