"""BENCHMARK.json and the files it names: names, units, coverage, and that a
new cell is data alone."""

import json
import os
import re
import shutil

import pytest
from portbench_tiny import ROOT, run_tiny

from portbench.harness.manifest import Cell, load, metric_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    return load(ROOT)


def test_names_and_units(manifest):
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    names = ([m["name"] for m in metrics] + [w["name"] for w in manifest["workloads"]]
             + [c["name"] for c in manifest["configs"]]
             + [w["traffic"] for w in manifest["workloads"]]
             + [k for c in manifest["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for group in (metrics, manifest["workloads"], manifest["configs"]):
        assert len({x["name"] for x in group}) == len(group)
    assert manifest["end_to_end"] and any(m["name"] == "setup_s" for m in manifest["end_to_end"])
    assert all(m["source"] in ("host_clock", "device_trace") for m in manifest["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in manifest["end_to_end"])
    assert 1 <= manifest["run_seconds"] <= 51


def test_each_layer_metric_moves_a_metric_its_cells_report(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    cells = [w["name"] for w in manifest["workloads"]]
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", cells)
        assert set(m.get("workloads", moved)) == set(moved), m["name"]
    for name in cells:
        c = Cell(manifest, name, ROOT)
        reported = {m["name"] for m in c.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert c.per_layer
        assert all(m["moves"] in reported for m in c.per_layer)


def test_every_name_finds_its_file(manifest):
    for c in manifest["configs"]:
        path = os.path.join(ROOT, c["file"])
        assert c["file"].startswith("portbench/") and os.path.isfile(path)
        assert json.load(open(path))["name"] == c["name"]
    for w in manifest["workloads"]:
        c = Cell(manifest, w["name"], ROOT)
        assert c.traffic["kind"] and c.limits, w["name"]
        assert w["chips"] == 1
    for m in manifest["per_layer"]:
        assert callable(metric_reader(m["name"], ROOT))


def test_a_new_cell_is_data_alone(tmp_path):
    """A cell added in a copy, by a traffic file and an entry, runs."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    tr = json.load(open(tmp_path / "portbench/traffic/serve_b8.json"))
    tr["batch"] = 4
    json.dump(tr, open(tmp_path / "portbench/traffic/serve_b4.json", "w"))
    shutil.copy(tmp_path / "portbench/limits/resnext50_early.serve_b8.json",
                tmp_path / "portbench/limits/resnext50_early.serve_b4.json")
    m = json.load(open(tmp_path / "BENCHMARK.json"))
    m["workloads"].append({"name": "resnext50_early.serve_b4", "config": "resnext50_early",
                           "traffic": "serve_b4", "chips": 1, "why": "a test"})
    for metric in m["end_to_end"] + m["per_layer"]:
        if "resnext50_early.serve_b8" in metric.get("workloads", []):
            metric["workloads"].append("resnext50_early.serve_b4")
    json.dump(m, open(tmp_path / "BENCHMARK.json", "w"))
    c = Cell(load(str(tmp_path)), "resnext50_early.serve_b4", str(tmp_path))
    assert c.traffic["batch"] == 4 and {x["name"] for x in c.end_to_end} >= {"setup_s"}
    r = run_tiny("resnext50_early.serve_b4", root=str(tmp_path))
    assert r["correct"] and r["attempted"] >= 1
    assert set(r["metrics"]) == {"serve_frames_per_s", "serve_p95_ms", "setup_s"}


@pytest.mark.parametrize("name", ["resnext50_early.serve_b8", "resnext50_early.serve_fullres_b1"])
def test_a_serving_run_reports_its_cells_end_to_end_metrics(manifest, name):
    r = run_tiny(name)
    assert set(r["metrics"]) == {m["name"] for m in Cell(manifest, name, ROOT).end_to_end}
