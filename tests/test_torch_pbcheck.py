"""The port's static checker (``repro_torch.analysis``,
``tools/pbcheck_torch.py``).

Every rule R1-R6 has a fixture trio under
``tests/fixtures/pbcheck_torch/``: a *violation* file the rule must
flag, a *clean* file it must pass, and a *suppressed* file whose inline
``# pbcheck: disable=Rn (reason)`` comments neutralize the findings.
R3, R5 and R6 keep the reference's semantics, so on the reference's
fixtures they give the reference's findings; R1, R2 and R4 are
retargeted to torch and CUDA graphs.  Suppressions without a reason are
invalid, the shipped baseline is justified, and ``src/repro_torch``
scans clean.
"""
import os
import subprocess
import sys

import pytest

from repro.analysis.cli import CheckConfig as JCheckConfig
from repro.analysis.cli import run_check as jrun_check
from repro_torch.analysis.baseline import TODO, Baseline, load_baseline
from repro_torch.analysis.cli import CheckConfig, run_check

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures", "pbcheck_torch")
REF_FIXTURES = os.path.join(HERE, "fixtures", "pbcheck")
REPO = os.path.dirname(HERE)
RULES = ["R1", "R2", "R3", "R4", "R5", "R6"]
_VIOLATIONS = {
    "R1": {"read-after-replay:first"},
    "R2": {"call:item", "call:np.asarray", "call:int", "call:synchronize"},
    "R3": {"attr:rounds"},
    "R4": {"capture-sync:item", "capture-alloc:self.scratch",
           "capture-data-shape:mask-index", "capture-data-shape:nonzero",
           "capture-in-loop"},
    "R5": {"unknown-kind:partial_cras", "unhandled-kind:partial_crash",
           "unhandled-kind:rejoin", "unknown-mode:replay"},
    "R6": {"missing-doc:function:undocumented"},
}


def _cfg(rule, cls=CheckConfig):
    return cls(rules=(rule,), hot_paths=("r2_",), docstring_paths=("r6_",))


def _run(rule, name):
    return run_check([os.path.join(FIXTURES, name)], _cfg(rule),
                     root=FIXTURES)


@pytest.mark.parametrize("rule", RULES)
def test_violation_fixture_is_flagged(rule):
    res = _run(rule, f"{rule.lower()}_violation.py")
    assert {f.detail for f in res.findings} == _VIOLATIONS[rule], \
        [f.render() for f in res.findings]
    assert all(f.rule == rule for f in res.findings)
    assert not res.invalid_suppressions


@pytest.mark.parametrize("rule", RULES)
def test_clean_fixture_passes(rule):
    res = _run(rule, f"{rule.lower()}_clean.py")
    assert res.ok, [f.render() for f in res.findings]
    assert not res.suppressed


@pytest.mark.parametrize("rule", RULES)
def test_suppressed_fixture_passes_with_reasons(rule):
    res = _run(rule, f"{rule.lower()}_suppressed.py")
    assert res.ok, [f.render() for f in res.findings]
    assert res.suppressed, f"{rule} suppression never matched a finding"
    assert all(reason for _, reason in res.suppressed)


@pytest.mark.parametrize("rule", ["R3", "R5", "R6"])
@pytest.mark.parametrize("kind", ["violation", "clean", "suppressed"])
def test_kept_rules_equal_the_reference(rule, kind):
    """On the reference's own fixtures R3, R5 and R6 give the
    reference's findings (rule, line, symbol, detail) and suppressions."""
    path = os.path.join(REF_FIXTURES, f"{rule.lower()}_{kind}.py")
    got = run_check([path], _cfg(rule), root=REF_FIXTURES)
    want = jrun_check([path], _cfg(rule, JCheckConfig), root=REF_FIXTURES)

    def key(res):
        return ([(f.rule, f.line, f.symbol, f.detail) for f in res.findings],
                [(f.line, reason) for f, reason in res.suppressed],
                res.invalid_suppressions)
    assert key(got) == key(want)


def test_suppression_without_reason_is_invalid(tmp_path):
    p = tmp_path / "bad.py"
    p.write_text("x = 1  # pbcheck: disable=R2\n")
    res = run_check([str(p)], CheckConfig(rules=("R2",)),
                    root=str(tmp_path))
    assert res.invalid_suppressions and not res.ok


def test_baseline_todo_justification_blocks():
    bl = Baseline({"R2|a.py|C|call:item": {
        "fingerprint": "R2|a.py|C|call:item", "rule": "R2",
        "justification": TODO}})
    assert bl.unjustified()


def test_shipped_baseline_is_justified():
    bl = load_baseline(os.path.join(REPO, "tools",
                                    "pbcheck_torch_baseline.json"))
    assert not bl.unjustified()


def test_port_scans_clean():
    """src/repro_torch has no unsuppressed finding, and every inline
    suppression in it carries a reason."""
    bl = load_baseline(os.path.join(REPO, "tools",
                                    "pbcheck_torch_baseline.json"))
    res = run_check([os.path.join(REPO, "src", "repro_torch")],
                    CheckConfig(), bl, root=REPO)
    assert res.ok, [f.render() for f in res.findings] + \
        [f"invalid suppression {p}:{ln}: {m}"
         for p, ln, m in res.invalid_suppressions]
    assert res.suppressed and all(reason for _, reason in res.suppressed)
    # the designed transfer points of the batcher are among them
    assert sum(f.rule == "R2" and f.path.endswith("serving/engine.py")
               for f, _ in res.suppressed) >= 3


def test_launcher_exits_zero_on_the_port():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "pbcheck_torch.py"),
         os.path.join(REPO, "src", "repro_torch"), "--baseline",
         os.path.join(REPO, "tools", "pbcheck_torch_baseline.json")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().endswith("OK")


def test_launcher_fails_on_a_violation():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "pbcheck_torch.py"),
         os.path.join(FIXTURES, "r4_violation.py"), "--rules", "R4"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 1 and "FAIL" in out.stdout
