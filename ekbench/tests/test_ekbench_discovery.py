"""Cells, configurations, generators and metrics are found by name from
files of their own, and BENCHMARK.json agrees with them."""

import importlib
import os

import pytest

from ekbench import data, harness

BENCH = data.benchmark()


def test_every_workload_has_its_cell_and_config():
    names = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        cell = data.cell(w["name"])
        assert cell["config"] == w["config"] and w["config"] in names
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert set(cell["limits"]) == {"eig_err", "residual", "orth"}
        assert w["chips"] == 1


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_found_by_name(entry):
    cfg = data.config(entry["name"])
    assert os.path.join(data.ROOT, entry["file"]) == os.path.join(
        data.HERE, "configs", f"{entry['name']}.json")
    assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]
    for params in cfg["matrices"].values():
        gen = importlib.import_module(f"ekbench.gen.{params['gen']}")
        assert callable(gen.coo)


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_per_layer_metric_has_its_reader(metric):
    path = os.path.join(data.HERE, "metrics", f"{metric['name']}.py")
    assert os.path.exists(path)
    empty = harness.LayerRun({}, 64, 64, 8, 8)
    assert harness.read_metric(metric["name"], empty) is None
    assert metric["moves"] == "solve_s"
    assert set(metric["workloads"]) <= {w["name"] for w in BENCH["workloads"]}


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"setup_s", "solve_s", "peak_mem_gib"}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())


def test_a_new_cell_is_a_new_file(tmp_path, monkeypatch):
    """A cell added as a file and an entry is found with no edit."""
    (tmp_path / "cells").mkdir()
    (tmp_path / "cells" / "x.y.json").write_text(
        '{"config": "vcnt22500", "solver": "eigh", "limits": {}}')
    monkeypatch.setattr(data, "HERE", str(tmp_path))
    assert data.cell("x.y")["solver"] == "eigh"


def test_a_new_metric_is_a_new_file(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "x_s.py").write_text(
        "def read(run):\n    return run.stage_s('sep:x')\n")
    monkeypatch.setattr(data, "HERE", str(tmp_path))
    run = harness.LayerRun({}, 64, 64, 8, 8, solves=2,
                           events={"sep:x": 3.0})
    assert harness.read_metric("x_s", run) == 1.5
