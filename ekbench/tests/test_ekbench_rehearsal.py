"""A CPU rehearsal of a run: set-up, the window loop, the traced solve,
the check and the result line, on a tiny configuration; and the
measurement path, which refuses to run without a card."""

import json
import os
import subprocess
import sys
import time

import pytest

from ekbench import data, harness
from ekbench.tests.tiny import E2E, cell, layers

WORKLOADS = [w["name"] for w in data.benchmark()["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_on_the_cpu(workload, trace):
    c, cfg = cell(workload)
    t = time.perf_counter()
    res = harness.run_cell(c, cfg, 2 ** 31 + 3, 0.3, bool(trace), "cpu",
                           E2E, layers(), t)
    obj = json.loads(harness.line(res))
    assert list(obj)[-1] == "checks" and list(obj)[:5] == [
        "correct", "attempted", "failed", "metrics", "device"]
    assert obj["correct"] is True and obj["failed"] == 0
    assert obj["attempted"] >= 1 + trace
    assert all(v["value"] <= v["limit"] for v in obj["checks"].values())
    if trace:
        # stage readers find their stages; the CPU has no device trace
        expect = {m["name"] for m in data.benchmark()["per_layer"]
                  if workload in m["workloads"]
                  and m["source"] == "program_span"}
        assert set(obj["metrics"]) == expect
        assert obj["device"]["busy_s"] == 0.0
    else:
        assert set(obj["metrics"]) == set(E2E)
        assert obj["metrics"]["solve_s"]["value"] > 0


def test_window_runs_until_the_seconds_have_passed():
    c, cfg = cell("vcnt22500.eigensx_full")
    res = harness.run_cell(c, cfg, 1, 0.0, False, "cpu", E2E, {},
                           time.perf_counter(), warm=False)
    assert res["attempted"] == 1


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "ekbench/run.py", "--workload", WORKLOADS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=data.ROOT, capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA device" in p.stderr


def test_run_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark,
    a run exits non-zero and prints no result."""
    import shutil

    shutil.copy(os.path.join(data.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(data.HERE, tmp_path / "ekbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "ekbench/run.py", "--workload", WORKLOADS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode != 0 and p.stdout == ""


def test_sample_columns_come_from_the_seed():
    a = harness.sample_columns(22500, 5)
    assert (a == harness.sample_columns(22500, 5)).all()
    assert not (a == harness.sample_columns(22500, 6)).all()
    assert a[0] == 0 and a[-1] == 22499 and len(a) <= 66
