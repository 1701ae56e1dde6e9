"""The mixed-precision cell and its refinement metrics: the frozen bound
of ``refine_roofline_pct``, both readers on a synthetic traced window,
and a CPU rehearsal of the cell with the metrics ``run.py`` selects for
it (those that list the cell)."""

import json
import time

import pytest

from ekbench import data, harness, run
from ekbench.harness import LayerRun, read_metric
from ekbench.metrics import refine_roofline_pct
from ekbench.tests.tiny import E2E, cell

MIXED = "vcnt22500_gen_mixed.elpa2_full"


def test_bound_is_three_products_at_the_fp64_tensor_peak():
    n = 22500
    gen = refine_roofline_pct.bound_s(n, n, True)
    assert gen == pytest.approx(6.0 * n ** 3 / 67e12)       # 1.02 s
    assert 1.01 < gen < 1.03
    assert refine_roofline_pct.bound_s(n, n, False) == \
        pytest.approx(gen * 2 / 3)
    # a thin block of vectors is still bounded by its products
    assert refine_roofline_pct.bound_s(n, 1, True) == pytest.approx(
        (2 * n * n + 2 * n) * 8 / 3.35e12)


@pytest.mark.parametrize("solver,gen", [("general_elpa2", True),
                                        ("eigensx", False)])
def test_readers_read_solve_refine_a_solve(solver, gen):
    n = 1000
    run_ = LayerRun({"solver": solver}, n, n, 64, 4, solves=2,
                    events={"solve:refine": 8.0, "sep:full_to_band": 1.0})
    assert read_metric("refine_s", run_) == 4.0
    assert read_metric("refine_roofline_pct", run_) == pytest.approx(
        100.0 * refine_roofline_pct.bound_s(n, n, gen) / 4.0)
    empty = LayerRun({"solver": solver}, n, n, 64, 4, solves=2,
                     events={"sep:full_to_band": 1.0})
    assert read_metric("refine_s", empty) is None
    assert read_metric("refine_roofline_pct", empty) is None


def test_the_cell_is_the_pencil_in_mixed_precision():
    bench = data.benchmark()
    work = next(w for w in bench["workloads"] if w["name"] == MIXED)
    c, cfg = data.cell(MIXED), data.config(work["config"])
    assert (c["solver"], c["n_vec"], c["dtype"], work["chips"]) == (
        "general_elpa2", None, "mixed", 1)
    assert c["limits"] == data.cell("vcnt22500_gen.elpa2_full")["limits"]
    f64 = data.config("vcnt22500_gen")
    assert (cfg["n"], cfg["matrices"], cfg["reduced"]) == (
        f64["n"], f64["matrices"], [])
    assert set(run._metrics(bench, "per_layer", MIXED)) == {
        "refine_s", "refine_roofline_pct"}


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_of_the_mixed_cell(trace):
    bench = data.benchmark()
    c, cfg = cell(MIXED)
    res = harness.run_cell(c, cfg, 2 ** 31 + 5, 0.3, bool(trace), "cpu",
                           E2E, run._metrics(bench, "per_layer", MIXED),
                           time.perf_counter())
    obj = json.loads(harness.line(res))
    assert obj["correct"] is True and obj["failed"] == 0
    want = {"refine_s", "refine_roofline_pct"} if trace else set(E2E)
    assert set(obj["metrics"]) == want
    # the CPU has no allocator peak
    assert all(obj["metrics"][key]["value"] > 0
               for key in want - {"peak_mem_gib"})
