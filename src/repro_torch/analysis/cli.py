"""``pbcheck`` CLI: run the rule suite, apply suppressions and the
baseline, report, and gate.

Exit codes: 0 = clean (every finding fixed, suppressed-with-reason, or
baselined-with-justification), 1 = new findings / invalid suppressions
/ unjustified baseline entries.  ``--report`` writes the full findings
JSON (including what was suppressed and why) for the CI artifact.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch \\
        --baseline tools/pbcheck_torch_baseline.json \\
        --report pbcheck_report.json
"""
from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from repro_torch.analysis.baseline import Baseline, load_baseline, write_baseline
from repro_torch.analysis.context import Module, iter_python_files, load_module
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import DESCRIPTIONS, RULES

DEFAULT_HOT_PATHS = ("serving/engine.py", "models/", "kernels/")
DEFAULT_DOCSTRING_PATHS = ("repro_torch/cluster/", "repro_torch/analysis/")


@dataclass
class CheckConfig:
    """Knobs the rules read (path scoping + rule selection)."""
    rules: Tuple[str, ...] = tuple(sorted(RULES))
    hot_paths: Tuple[str, ...] = DEFAULT_HOT_PATHS
    docstring_paths: Tuple[str, ...] = DEFAULT_DOCSTRING_PATHS


@dataclass
class CheckResult:
    """Everything one run produced, pre-gating."""
    findings: List[Finding] = field(default_factory=list)   # new (gate)
    suppressed: List[Tuple[Finding, str]] = field(default_factory=list)
    baselined: List[Finding] = field(default_factory=list)
    invalid_suppressions: List[Tuple[str, int, str]] = \
        field(default_factory=list)
    stale_baseline: List[str] = field(default_factory=list)
    n_files: int = 0

    @property
    def ok(self) -> bool:
        return not self.findings and not self.invalid_suppressions


def collect_findings(modules: Sequence[Module],
                     config: CheckConfig) -> List[Finding]:
    """Run every selected rule over ``modules`` (no gating applied)."""
    out: List[Finding] = []
    for rule_id in config.rules:
        rule = RULES[rule_id]
        if hasattr(rule, "check"):
            for m in modules:
                out.extend(rule.check(m, config))
        if hasattr(rule, "check_project"):
            out.extend(rule.check_project(modules, config))
    return sorted(out, key=lambda f: (f.path, f.line, f.rule, f.detail))


def run_check(paths: Sequence[str], config: Optional[CheckConfig] = None,
              baseline: Optional[Baseline] = None,
              root: str = ".") -> CheckResult:
    """Scan ``paths``, returning raw/suppressed/baselined findings.

    This is the library entry the tests drive; ``main`` wraps it with
    argument parsing, reporting, and exit-code policy.
    """
    config = config or CheckConfig()
    baseline = baseline or Baseline()
    modules = [load_module(p, root) for p in iter_python_files(list(paths))]
    result = CheckResult(n_files=len(modules))
    all_findings = collect_findings(modules, config)
    by_path = {m.path: m for m in modules}
    for f in all_findings:
        sup = by_path[f.path].suppressions
        if sup.active(f.line, f.rule):
            result.suppressed.append(
                (f, sup.reasons.get((f.line, f.rule), "")))
        elif baseline.matches(f):
            result.baselined.append(f)
        else:
            result.findings.append(f)
    for m in modules:
        for line, msg in m.suppressions.invalid:
            result.invalid_suppressions.append((m.path, line, msg))
    result.stale_baseline = baseline.stale(all_findings)
    return result


def _write_report(path: str, result: CheckResult,
                  config: CheckConfig) -> None:
    doc = {
        "version": 1,
        "rules": {r: DESCRIPTIONS[r] for r in config.rules},
        "n_files": result.n_files,
        "findings": [vars(f) | {"fingerprint": f.fingerprint}
                     for f in result.findings],
        "baselined": [vars(f) | {"fingerprint": f.fingerprint}
                      for f in result.baselined],
        "suppressed": [vars(f) | {"reason": reason}
                       for f, reason in result.suppressed],
        "invalid_suppressions": [
            {"path": p, "line": ln, "message": msg}
            for p, ln, msg in result.invalid_suppressions],
        "stale_baseline": result.stale_baseline,
    }
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1)
        fh.write("\n")


def main(argv=None) -> int:
    """Argparse entry point (see module docstring for the contract)."""
    ap = argparse.ArgumentParser(
        prog="pbcheck",
        description="PipeBoost static-analysis suite (rules R1-R6)")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories to scan (default: src/repro_torch)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset (default: all)")
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON of accepted findings")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite --baseline from current findings "
                         "(new entries get a TODO justification that "
                         "must be edited before the run passes)")
    ap.add_argument("--report", default=None,
                    help="write the findings report JSON here")
    ap.add_argument("--hot-paths", default=",".join(DEFAULT_HOT_PATHS),
                    help="comma-separated path substrings R2 treats as "
                         "hot-path modules")
    ap.add_argument("--docstring-paths",
                    default=",".join(DEFAULT_DOCSTRING_PATHS),
                    help="comma-separated path substrings R6 scopes to")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="also list suppressed and baselined findings")
    args = ap.parse_args(argv)

    rules = tuple(sorted(RULES))
    if args.rules:
        rules = tuple(sorted(r.strip().upper()
                             for r in args.rules.split(",") if r.strip()))
        unknown = [r for r in rules if r not in RULES]
        if unknown:
            raise SystemExit(f"unknown rules {unknown}; "
                             f"available: {sorted(RULES)}")
    config = CheckConfig(
        rules=rules,
        hot_paths=tuple(p for p in args.hot_paths.split(",") if p),
        docstring_paths=tuple(p for p in args.docstring_paths.split(",")
                              if p))
    baseline = load_baseline(args.baseline) if args.baseline \
        else Baseline()
    paths = args.paths or ["src/repro_torch"]
    result = run_check(paths, config, baseline)

    if args.write_baseline:
        if not args.baseline:
            raise SystemExit("--write-baseline requires --baseline PATH")
        write_baseline(args.baseline,
                       result.findings + result.baselined, baseline)
        print(f"pbcheck: wrote {len(result.findings + result.baselined)} "
              f"entries to {args.baseline} (edit any TODO justifications)")
        return 0

    for f in result.findings:
        print(f.render())
    for path, line, msg in result.invalid_suppressions:
        print(f"{path}:{line}:0: SUP invalid suppression: {msg}")
    if args.verbose:
        for f, reason in result.suppressed:
            print(f"# suppressed: {f.render()}  ({reason})")
        for f in result.baselined:
            print(f"# baselined: {f.render()}")
    for fp in result.stale_baseline:
        print(f"# stale baseline entry (no longer found): {fp}")
    bad_baseline = baseline.unjustified()
    for e in bad_baseline:
        print(f"BASELINE {e['fingerprint']}: justification missing/TODO")
    if args.report:
        _write_report(args.report, result, config)

    n_new = len(result.findings)
    print(f"pbcheck: {result.n_files} files, rules {','.join(rules)}: "
          f"{n_new} new, {len(result.suppressed)} suppressed, "
          f"{len(result.baselined)} baselined"
          + (f", {len(result.invalid_suppressions)} invalid suppressions"
             if result.invalid_suppressions else ""))
    if n_new or result.invalid_suppressions or bad_baseline:
        print("FAIL")
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
