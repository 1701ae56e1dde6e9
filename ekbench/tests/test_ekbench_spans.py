"""The readers of the program's spans, on a synthetic traced window: each
reads its span's seconds a solve, and None where the program records no
such span (a parent without them)."""

import pytest

from ekbench import data
from ekbench.harness import LayerRun, read_metric

SPANS = {"to_band_panel_s": "to_band:panel",
         "to_band_update_s": "to_band:update",
         "tridiagonalize_panel_s": "tridiagonalize:panel",
         "tridiagonalize_update_s": "tridiagonalize:update"}
STAGES = {"sep:full_to_band": 20.0, "sep:tridiagonalize": 40.0,
          "!sep:full_to_band_Gflops": 9.0}


def _run(events, solves=2):
    return LayerRun({}, 64, 64, 8, 8, solves=solves, events=events)


@pytest.mark.parametrize("metric,name", sorted(SPANS.items()))
def test_span_reader_reads_its_span_a_solve(metric, name):
    events = dict(STAGES, **{n: 1.0 for n in SPANS.values()})
    events[name] = 7.0
    assert read_metric(metric, _run(events)) == 3.5
    assert read_metric(metric, _run(STAGES)) is None


def test_host_wait_is_every_wait_span_a_solve():
    events = dict(STAGES, **{"wait:drain": 3.0, "wait:dc_depths": 0.5,
                             "wait:cholesky_info": 0.5,
                             "to_band:panel": 11.0})
    assert read_metric("host_wait_s", _run(events, 4)) == 1.0
    assert read_metric("host_wait_s", _run(STAGES)) is None


def test_new_metrics_read_program_spans_and_move_solve_s():
    per_layer = {m["name"]: m for m in data.benchmark()["per_layer"]}
    for name in list(SPANS) + ["host_wait_s"]:
        m = per_layer[name]
        assert (m["source"], m["moves"], m["unit"]) == \
            ("program_span", "solve_s", "s")
    two = {"vcnt22500_gen.elpa2_full", "vcnt22500.eigensx_full"}
    assert set(per_layer["to_band_panel_s"]["workloads"]) == two
    assert set(per_layer["tridiagonalize_panel_s"]["workloads"]) == {
        "vcnt22500_gen.select_low500"}
    assert set(per_layer["host_wait_s"]["workloads"]) == two | {
        "vcnt22500_gen.select_low500"}
