"""chase_roofline_pct (layer: bulge chase, B3): the frozen bound of B3
(``ekbench/roofline.py::bound_chase``) over B3's device time
(``chase_kernel``) in the profiled solve."""

from ekbench import roofline
from ekbench.harness import say


def read(run):
    ms = run.trace.kernel_ms("chase_kernel") if run.trace else 0.0
    if ms <= 0:
        return None
    bound, by = roofline.bound_chase(run.n, run.bw, run.itemsize)
    say(f"roofline B3: bound {bound} ms ({by}), device {ms} ms")
    return 100.0 * bound / ms
