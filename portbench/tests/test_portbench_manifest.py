"""The manifest, and the harness finding every file by its name."""

import json
import shutil

import pytest

from portbench import harness, manifest, trace
from portbench.tests.small import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_finds_its_files(workload):
    cell = manifest.cell(BENCH, workload)
    assert manifest.module("models", cell.config["model"])
    driver = manifest.module("drivers", cell.traffic["driver"])
    for fn in ("setup", "window", "traced", "answers", "check"):
        assert callable(getattr(driver, fn))
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in names
        assert callable(manifest.metric_reader(m["name"]))
    assert set(cell.limits) == {"gtrg4-advi": {"loss_gap", "grad1_gap",
                                               "change3_gap"},
                                "gtrg4-api-f64": {"logl_gap", "grad_gap"}
                                }.get(workload, {"logp_gap", "still_chains"})


def test_metric_files_match_the_manifest():
    files = {p.stem for p in (ROOT / "portbench" / "metrics").glob("*.py")}
    assert files == {m["name"] for m in BENCH["per_layer"]}


def test_a_new_metric_file_is_read_without_editing_any_other(tmp_path):
    """A metric added as one file and one manifest entry shows up in the
    result."""
    root = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "metrics" / "dummy_kernels.py").write_text(
        "def read(r):\n    return float(len(r.window.kernels()))\n")
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"].append(
        {"name": "dummy_kernels", "unit": "launches", "better": "lower",
         "source": "device_trace", "layer": "device",
         "moves": "advi_steps_per_s", "workloads": ["gtrg4-advi"]})
    cell = manifest.cell(bench, "gtrg4-advi", root)
    window = trace.Window([("void k<float>()", 0.0, 5.0)] * 3, [],
                          (0.0, 10.0), 1, {})
    reading = harness.Reading(window, {"T": 4, "I": 3, "C": 1, "S": 4,
                                       "maxc": 2, "P": 8}, 1, 4)
    got = harness.read_metrics(cell.per_layer, reading, root)
    assert got["dummy_kernels"] == {"value": 3.0, "unit": "launches"}
    assert "launches_per_step.advi" in got


def test_benchmark_json_keeps_to_its_limits():
    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    assert set(BENCH) == keys
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
