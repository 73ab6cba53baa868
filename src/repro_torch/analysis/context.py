"""Shared per-module analysis context: parse tree, enclosing-symbol
map, suppressions, and the module's CUDA-graph registry.

Every rule consumes a :class:`Module`; cross-module rules (R5) get the
whole list.  The graph registry is what R1 and R4 share: the bindings a
module assigns from ``torch.cuda.CUDAGraph()``, the ``with
torch.cuda.graph(...)`` capture blocks, and the bindings assigned inside
them (a capture's static outputs), so call sites can be matched without
type inference — a binding string is ``"name"`` for locals/globals and
``"self.name"`` for instance attributes.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from repro_torch.analysis.suppress import Suppressions, parse_suppressions


def binding_str(node: ast.AST) -> Optional[str]:
    """``Name`` -> ``"x"``; ``self.x`` -> ``"self.x"``; else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute) \
            and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return f"self.{node.attr}"
    return None


def is_capture(node: ast.AST) -> bool:
    """True for a ``with`` whose item is ``torch.cuda.graph(...)``."""
    if not isinstance(node, (ast.With, ast.AsyncWith)):
        return False
    for item in node.items:
        f = getattr(item.context_expr, "func", None)
        if isinstance(f, ast.Attribute) and f.attr == "graph" \
                and isinstance(f.value, ast.Attribute) \
                and f.value.attr == "cuda":
            return True
    return False


def assigned_bindings(node: ast.AST) -> List[str]:
    """Bindings a statement tree assigns (tuple targets unpacked)."""
    out: List[str] = []
    for sub in ast.walk(node):
        targets = []
        if isinstance(sub, ast.Assign):
            targets = sub.targets
        elif isinstance(sub, (ast.AugAssign, ast.AnnAssign)):
            targets = [sub.target]
        for t in targets:
            for part in ast.walk(t):
                key = binding_str(part)
                if key is not None and isinstance(
                        getattr(part, "ctx", None), ast.Store):
                    out.append(key)
    return out


@dataclass
class Module:
    """One parsed source file plus the lookups rules share."""
    path: str                      # repo-relative posix path
    source: str
    tree: ast.Module
    suppressions: Suppressions
    # bindings assigned from torch.cuda.CUDAGraph()
    graphs: Set[str] = field(default_factory=set)
    # the ``with torch.cuda.graph(...)`` blocks
    captures: List[ast.AST] = field(default_factory=list)
    # bindings assigned inside a capture block: its static outputs
    static_outputs: Set[str] = field(default_factory=set)
    # ast node id -> enclosing qualname ("Cls.method")
    _qualnames: Dict[int, str] = field(default_factory=dict)

    def qualname(self, node: ast.AST) -> str:
        """Enclosing class/function qualname for a node ("" = module)."""
        return self._qualnames.get(id(node), "")

    def matches(self, patterns) -> bool:
        """True if any pattern is a substring of this module's path."""
        return any(p in self.path for p in patterns)


def _index_qualnames(tree: ast.Module) -> Dict[int, str]:
    out: Dict[int, str] = {}

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                q = f"{prefix}.{child.name}" if prefix else child.name
                for sub in ast.walk(child):
                    out.setdefault(id(sub), q)
                visit(child, q)
            else:
                visit(child, prefix)

    visit(tree, "")
    return out


def _collect_graphs(tree: ast.Module):
    graphs: Set[str] = set()
    captures: List[ast.AST] = []
    static: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.value, ast.Call) \
                and isinstance(node.value.func, ast.Attribute) \
                and node.value.func.attr == "CUDAGraph":
            key = binding_str(node.targets[0])
            if key is not None:
                graphs.add(key)
        if is_capture(node):
            captures.append(node)
            for stmt in node.body:
                static.update(assigned_bindings(stmt))
    return graphs, captures, static


def load_module(path: str, root: str = ".") -> Module:
    """Parse ``path`` into a :class:`Module` (raises SystemExit on a
    syntax error — an unparseable file IS a finding-worthy failure)."""
    with open(path, encoding="utf-8") as f:
        source = f.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        raise SystemExit(f"{path}: not parseable: {e}")
    rel = os.path.relpath(path, root).replace(os.sep, "/")
    graphs, captures, static = _collect_graphs(tree)
    return Module(path=rel, source=source, tree=tree,
                  suppressions=parse_suppressions(source),
                  graphs=graphs, captures=captures, static_outputs=static,
                  _qualnames=_index_qualnames(tree))


def iter_python_files(roots: List[str]) -> List[str]:
    """Deterministic .py file discovery under files/directories."""
    out: List[str] = []
    for root in roots:
        if os.path.isfile(root):
            out.append(root)
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__", ".git"))
            out.extend(os.path.join(dirpath, fn)
                       for fn in sorted(filenames) if fn.endswith(".py"))
    return out
