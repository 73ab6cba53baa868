"""Checked-in baseline: accepted findings with written justifications.

The baseline lets ``pbcheck`` land with a clean bill even when a rule
has known, *deliberate* violations — but every entry must carry a
justification, and CI fails on any finding that is neither suppressed
inline nor baselined.  Workflow:

* a new finding appears  -> fix it, suppress it inline with a reason,
  or add it here with ``--write-baseline`` and then EDIT the generated
  ``justification`` (entries still reading ``TODO`` fail the run);
* a baselined finding disappears -> the run reports the stale entry so
  it can be pruned (stale entries warn, they don't fail).

Format (version 1)::

    {"version": 1, "entries": [
        {"fingerprint": "R2|src/...|Cls.fn|call:np.asarray",
         "rule": "R2", "justification": "the one designed transfer"}]}
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

from repro_torch.analysis.findings import Finding

TODO = "TODO: justify or fix"


@dataclass
class Baseline:
    """Accepted-findings ledger keyed by fingerprint."""
    entries: Dict[str, dict] = field(default_factory=dict)

    def matches(self, finding: Finding) -> bool:
        """True when ``finding`` is an accepted (baselined) finding."""
        return finding.fingerprint in self.entries

    def unjustified(self) -> List[dict]:
        """Entries whose justification is missing or still the TODO."""
        return [e for e in self.entries.values()
                if not str(e.get("justification", "")).strip()
                or e.get("justification") == TODO]

    def stale(self, findings: Sequence[Finding]) -> List[str]:
        """Baselined fingerprints no finding matched this run."""
        seen = {f.fingerprint for f in findings}
        return sorted(fp for fp in self.entries if fp not in seen)


def load_baseline(path: str) -> Baseline:
    """Read a baseline file; a missing file is an empty baseline."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except FileNotFoundError:
        return Baseline()
    if doc.get("version") != 1:
        raise SystemExit(
            f"{path}: unknown baseline version {doc.get('version')!r}")
    entries = {}
    for e in doc.get("entries", []):
        fp = e.get("fingerprint")
        if not fp:
            raise SystemExit(f"{path}: baseline entry without fingerprint")
        entries[fp] = e
    return Baseline(entries)


def write_baseline(path: str, findings: Sequence[Finding],
                   old: Baseline) -> None:
    """Serialize ``findings`` as the new baseline, carrying existing
    justifications over and stamping ``TODO`` on new entries (which
    must be edited before the baseline passes)."""
    entries = []
    seen = set()
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        if f.fingerprint in seen:
            continue
        seen.add(f.fingerprint)
        prev = old.entries.get(f.fingerprint, {})
        entries.append({
            "fingerprint": f.fingerprint,
            "rule": f.rule,
            "justification": prev.get("justification", TODO),
        })
    with open(path, "w") as fh:
        json.dump({"version": 1, "entries": entries}, fh, indent=1)
        fh.write("\n")
