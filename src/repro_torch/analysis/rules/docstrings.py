"""R6 — docstring coverage for the documented layers.

A stdlib stand-in for ``interrogate``, in the single ``pbcheck`` lane:
within the scoped paths (``config.docstring_paths`` — by default the
port's cluster layer and this analysis package), every public module,
class, and function/method must carry a docstring, reported per item
instead of as a coverage percentage so each miss is fixable,
suppressible, or baselinable like any other finding.

Exclusions mirror interrogate's defaults: dunders
(``__init__`` is documented by its class), ``@property`` accessors
(the name is the doc), functions nested inside functions, and anything
under a private scope.
"""
from __future__ import annotations

import ast
from typing import List, Tuple

from repro_torch.analysis.context import Module
from repro_torch.analysis.findings import Finding


def _is_public(name: str) -> bool:
    return not name.startswith("_")


def _is_property(node: ast.AST) -> bool:
    for dec in getattr(node, "decorator_list", []):
        if isinstance(dec, ast.Name) and dec.id == "property":
            return True
        if isinstance(dec, ast.Attribute) and dec.attr in ("getter",
                                                           "setter",
                                                           "deleter"):
            return True
    return False


def iter_defs(tree: ast.Module):
    """Yield ``(node, qualname, kind, has_docstring)`` per checkable
    definition — the module itself, public classes, and public
    functions/methods (same walk as the legacy docstring gate)."""
    yield tree, "<module>", "module", ast.get_docstring(tree) is not None
    stack: List[Tuple[ast.AST, str]] = [(tree, "")]
    while stack:
        node, prefix = stack.pop()
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                qual = f"{prefix}{child.name}"
                if _is_public(child.name) and not _is_property(child):
                    kind = ("class" if isinstance(child, ast.ClassDef)
                            else "function")
                    yield (child, qual, kind,
                           ast.get_docstring(child) is not None)
                if isinstance(child, ast.ClassDef) \
                        and _is_public(child.name):
                    stack.append((child, f"{qual}."))


def check(module: Module, config) -> List[Finding]:
    """Flag each missing public docstring inside the scoped paths."""
    if not module.matches(config.docstring_paths):
        return []
    findings: List[Finding] = []
    for node, qual, kind, has_doc in iter_defs(module.tree):
        if has_doc:
            continue
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        findings.append(Finding(
            "R6", module.path, line, col, qual,
            f"missing-doc:{kind}:{qual}",
            f"public {kind} `{qual}` has no docstring (the documented "
            f"layers keep 100% public-API coverage)"))
    return findings
