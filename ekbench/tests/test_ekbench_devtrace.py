"""The idle share and the naming of idle gaps, on synthetic intervals."""

import pytest

from ekbench import devtrace


def test_union_merges_overlaps_and_clips_to_the_window():
    busy, gaps = devtrace.union(
        [(0, 10), (5, 20), (30, 40), (35, 38), (90, 200)], 2, 100)
    assert busy == (20 - 2) + (40 - 30) + (100 - 90)
    assert gaps == [(20, 30), (40, 90)]


def test_union_of_nothing_is_one_gap():
    assert devtrace.union([], 0, 50) == (0, [(0, 50)])


def test_idle_share_of_a_synthetic_trace():
    busy, gaps = devtrace.union([(10, 30), (50, 60)], 0, 100)
    tr = devtrace.Trace(window_s=100e-9, busy_s=busy * 1e-9)
    from ekbench.metrics import device_idle_pct  # noqa: F401  (a file)
    from ekbench.harness import LayerRun, read_metric
    run = LayerRun({}, 1, 1, 1, 8, trace=tr)
    assert abs(read_metric("device_idle_pct", run) - 70.0) < 1e-9
    assert sum(e - s for s, e in gaps) == 70


def test_gaps_are_named_by_stage_and_innermost_host_op():
    stages = [(10, 60, "sep:full_to_band"), (60, 95, "sep:chase")]
    host = [(20, 30, "cudaLaunchKernel"), (22, 26, "cuLaunchKernel"),
            (70, 90, "cudaDeviceSynchronize")]
    out = devtrace.name_gaps([(22, 28), (40, 50), (75, 85), (95, 99),
                              (1, 5)], host, stages)
    want = {"sep:full_to_band > cuLaunchKernel": 6e-9,
            "sep:full_to_band": 10e-9,
            "sep:chase > cudaDeviceSynchronize": 10e-9,
            "(no host op)": 8e-9}
    assert out == pytest.approx(want, rel=1e-12)


def test_stamped_log_stamps_each_stage():
    log = devtrace.StampedLog()
    log.add_event("sep:x", 0.5)
    log.add_event("!sep:x_Gflops", 3.0)
    (s, e, name), = log.stamps
    assert name == "sep:x" and e - s == 500_000_000


def test_kernel_time_and_breakdown():
    tr = devtrace.Trace(by_name={"void chase_kernel<double>": 0.5,
                                 "wf_bt_f64_resident": 0.25,
                                 "wf_bt_f64_kernel": 0.25, "gemm": 2.0},
                        gaps={"a": 1.0, "b": 3.0})
    assert tr.kernel_ms("wf_bt_f") == 500.0
    assert tr.kernel_ms("chase_kernel") == 500.0
    bd = tr.breakdown(top=2)
    assert bd["device_ops"] == [["gemm", 2.0],
                                ["void chase_kernel<double>", 0.5]]
    assert bd["idle_gaps"] == [["b", 3.0], ["a", 1.0]]
