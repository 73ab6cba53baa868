"""Inline suppression comments: ``# pbcheck: disable=R3 (reason)``.

A suppression silences the named rule(s) for findings on the same
source line, or — when the comment stands on its own line — the next
code line below it.  The parenthesized reason is REQUIRED: a
suppression without one does not suppress anything and is itself
reported, so "shut it up" can never masquerade as "thought about it".
Multiple rules: ``disable=R2,R3``.
"""
from __future__ import annotations

import io
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple

_PAT = re.compile(
    r"#\s*pbcheck:\s*disable=(?P<rules>[A-Za-z0-9,\s]+?)"
    r"\s*(?:\((?P<reason>[^)]*)\))?\s*$")


@dataclass
class Suppressions:
    """Parsed suppressions for one module."""
    # code line -> set of rule ids silenced on that line
    by_line: Dict[int, Set[str]] = field(default_factory=dict)
    # reasons keyed by (line, rule) — kept for the findings report
    reasons: Dict[Tuple[int, str], str] = field(default_factory=dict)
    # malformed suppressions (no reason / no rules): (line, message)
    invalid: List[Tuple[int, str]] = field(default_factory=list)
    # (line, rule) pairs that actually silenced a finding
    used: Set[Tuple[int, str]] = field(default_factory=set)

    def active(self, line: int, rule: str) -> bool:
        """True (and mark used) if ``rule`` is silenced on ``line``."""
        if rule in self.by_line.get(line, ()):
            self.used.add((line, rule))
            return True
        return False


def parse_suppressions(source: str) -> Suppressions:
    """Extract every pbcheck suppression comment from ``source``.

    Own-line comments attach to the next non-comment, non-blank line
    (the statement they annotate); trailing comments attach to their
    own line.
    """
    sup = Suppressions()
    comments: List[Tuple[int, int, str]] = []   # (line, col, text)
    try:
        toks = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in toks:
            if tok.type == tokenize.COMMENT:
                comments.append((tok.start[0], tok.start[1], tok.string))
    except tokenize.TokenError:
        return sup          # unparseable tail: no suppressions there
    code_lines = _code_line_set(source)
    for line, col, text in comments:
        m = _PAT.search(text)
        if m is None:
            if "pbcheck:" in text:
                sup.invalid.append(
                    (line, f"unrecognized pbcheck comment {text!r}"))
            continue
        rules = {r.strip().upper() for r in m.group("rules").split(",")
                 if r.strip()}
        reason = (m.group("reason") or "").strip()
        if not rules:
            sup.invalid.append((line, "suppression names no rules"))
            continue
        if not reason:
            sup.invalid.append(
                (line, "suppression without a (reason) is ignored: "
                       f"{text.strip()!r}"))
            continue
        own_line = col == 0 or line not in code_lines
        target = _next_code_line(code_lines, line) if own_line else line
        sup.by_line.setdefault(target, set()).update(rules)
        for r in rules:
            sup.reasons[(target, r)] = reason
    return sup


def _code_line_set(source: str) -> Set[int]:
    """Lines carrying code (not blank, not comment-only)."""
    out: Set[int] = set()
    for i, raw in enumerate(source.splitlines(), start=1):
        s = raw.strip()
        if s and not s.startswith("#"):
            out.add(i)
    return out


def _next_code_line(code_lines: Set[int], after: int) -> int:
    """First code line strictly below ``after`` (or ``after`` itself
    when the file ends in comments — the suppression then dangles
    harmlessly)."""
    later = [ln for ln in code_lines if ln > after]
    return min(later) if later else after
