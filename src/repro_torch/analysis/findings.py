"""Finding record + stable fingerprints (the baseline currency).

A fingerprint intentionally omits line numbers: baselined findings must
survive unrelated edits above them, so identity is
``rule | path | enclosing symbol | rule-specific detail`` — the same
scheme ``ruff``/``pylint`` baselines use.  Two findings with the same
fingerprint are the same *kind* of violation at the same place; a
baseline entry matches all of them.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""
    rule: str        # "R1".."R6"
    path: str        # repo-relative posix path
    line: int        # 1-based
    col: int         # 0-based
    symbol: str      # enclosing qualname ("" at module level)
    detail: str      # stable, line-free identity token (e.g. "attr:rounds")
    message: str     # human-readable explanation

    @property
    def fingerprint(self) -> str:
        """Line-number-free identity used for baseline matching."""
        return f"{self.rule}|{self.path}|{self.symbol}|{self.detail}"

    def render(self) -> str:
        """One-line ``path:line:col: RULE [symbol] message`` report row."""
        sym = f" [{self.symbol}]" if self.symbol else ""
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule}{sym} {self.message}")
