"""The manifest: allowed names and units, and data files found by name."""
import json
import shutil

import pytest

from pbb import manifest


def test_names_and_units_use_the_allowed_characters():
    assert manifest.check_names(manifest.load_benchmark()) == []


@pytest.mark.parametrize("name,ok", [
    ("opt-lora-chat", True), ("decode_step_ms.chat", True),
    ("a b", False), ("a/b", False), (".hidden", False), ("x" * 65, False),
    ("µs", False)])
def test_name_rule(name, ok):
    assert bool(manifest.NAME_RE.match(name)) is ok


@pytest.mark.parametrize("unit,ok", [("tokens/s", True), ("%", True),
                                     ("GiB", True), ("tokens per s", False)])
def test_unit_rule(unit, ok):
    assert bool(manifest.UNIT_RE.match(unit)) is ok


def test_every_cell_metric_and_file_resolves():
    bench = manifest.load_benchmark()
    for w in bench["workloads"]:
        assert manifest.config(w["config"])["name"] == w["config"]
        manifest.traffic(w["traffic"])
        for trace in (False, True):
            mets = manifest.cell_metrics(bench, w["name"], trace)
            assert mets
            for m in mets:
                assert callable(manifest.reader(m["name"]))
        e2e = {m["name"] for m in manifest.cell_metrics(bench, w["name"],
                                                        False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        for m in manifest.cell_metrics(bench, w["name"], True):
            assert m["moves"] in e2e


def test_a_dropped_in_workload_is_found_by_name(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    shutil.copytree(manifest.BENCH_DIR, root / "pbbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = manifest.load_benchmark()
    spec = manifest.traffic("opt-lora-chat")
    spec["arrivals"]["rate"] = 1.0
    (root / "pbbench" / "workloads" / "opt-slow-chat.json").write_text(
        json.dumps(spec))
    bench["workloads"].append({"name": "opt-slow-chat",
                               "config": "pipeboost-opt-1.3b",
                               "traffic": "opt-slow-chat", "chips": 1,
                               "why": "slow"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(manifest, "BENCH_DIR", root / "pbbench")
    got = manifest.load_benchmark(root)
    cell = manifest.cell(got, "opt-slow-chat")
    assert manifest.traffic(cell["traffic"])["arrivals"]["rate"] == 1.0
    # metrics listed without a workloads key would follow it; those with
    # one do not
    assert [m["name"] for m in manifest.cell_metrics(got, "opt-slow-chat",
                                                     False)] == \
        [m["name"] for m in got["end_to_end"] if "workloads" not in m]
