"""wf_bt_roofline_pct (layer: back-transform, B4): the frozen bound of B4
(``ekbench/roofline.py::bound_wf_bt``) over the device time of all B4's
launches (``wf_bt_f64_*`` / ``wf_bt_f32_*``) in the profiled solve."""

from ekbench import roofline
from ekbench.harness import say


def read(run):
    ms = run.trace.kernel_ms("wf_bt_f") if run.trace else 0.0
    if ms <= 0:
        return None
    bound, by, launches, steps = roofline.bound_wf_bt(run.n, run.n_vec,
                                                      run.bw, run.itemsize)
    say(f"roofline B4: bound {bound} ms ({by}; {launches} launches, "
        f"{steps} lane-steps), device {ms} ms")
    return 100.0 * bound / ms
