"""R1 — static buffers after replay.

A captured CUDA graph reads and writes the same device buffers on every
``replay()``: its outputs are *static*, overwritten in place by the next
replay.  A tensor taken from one without a copy (``out = static_out``,
``row = self._dev_tokens[slot]``) is an alias, not a value: read after a
later ``replay()`` it holds the later step's result, silently.  This is
the torch counterpart of reading a buffer after the call that donated
it, and the port's decode step rides exactly such a graph (its tokens
and cache are the step's static I/O).

The rule: the static outputs are the bindings a module assigns inside a
``with torch.cuda.graph(...)`` block.  In every function, a name bound
to such a binding — bare, subscripted or through attributes, but not
through a copy (``.clone()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
``.item()``, ``.copy()``, ``copy.deepcopy``, ``torch.clone``) — is
tainted from its assignment; a read of it after a lexically later
``<graph>.replay()`` in the same function, before the name is bound
again, is flagged.  Straight-line by design, as the other rules are:
a loop that takes the alias and replays in each iteration rebinds it on
the alias's own line.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.analysis.context import Module, binding_str
from repro_torch.analysis.findings import Finding


def _static_source(node: ast.AST, static) -> Optional[str]:
    """The static output ``node`` aliases (through subscripts and
    attributes), or None when it is a copy or something else."""
    while True:
        key = binding_str(node)
        if key in static:
            return key
        if isinstance(node, (ast.Subscript, ast.Attribute)):
            node = node.value
            continue
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr in ("view", "reshape", "narrow",
                                       "select", "squeeze", "unsqueeze",
                                       "flatten", "t", "transpose",
                                       "permute", "expand", "detach"):
            node = node.func.value
            continue
        return None


def _replay_lines(fn: ast.AST) -> List[int]:
    return [n.lineno for n in ast.walk(fn)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "replay" and not n.args]


def check(module: Module, config) -> List[Finding]:
    """Flag reads of an alias of a static output after a later replay."""
    findings: List[Finding] = []
    static = module.static_outputs
    if not static:
        return findings
    fns = [n for n in ast.walk(module.tree)
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for fn in fns:
        replays = _replay_lines(fn)
        if not replays:
            continue
        binds = {}          # alias name -> lines bound
        aliases = []        # (name, line, static source)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                key = binding_str(t)
                if key is None:
                    continue
                binds.setdefault(key, []).append(node.lineno)
                src = _static_source(node.value, static)
                if src is not None and key not in static:
                    aliases.append((key, node.lineno, src))
        for key, line, src in aliases:
            later = [r for r in replays if r > line]
            if not later:
                continue
            replay = min(later)
            rebind = min([ln for ln in binds.get(key, []) if ln > line],
                         default=10 ** 9)
            for node in ast.walk(fn):
                if binding_str(node) == key \
                        and isinstance(getattr(node, "ctx", None),
                                       ast.Load) \
                        and replay < node.lineno <= rebind \
                        and node.lineno != rebind:
                    findings.append(Finding(
                        "R1", module.path, node.lineno, node.col_offset,
                        module.qualname(node), f"read-after-replay:{key}",
                        f"`{key}` aliases the graph's static output "
                        f"`{src}` (line {line}) and is read after the "
                        f"replay on line {replay}, which overwrote it — "
                        f"copy it before the replay"))
                    break       # one finding per alias
    return findings
