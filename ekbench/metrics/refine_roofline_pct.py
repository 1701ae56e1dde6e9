"""refine_roofline_pct (layer: mixed-precision refinement,
``ops/refine.py``): a frozen bound of any refinement of k pairs over
``refine_s``.

The least work that refines k pairs of an n x n problem in float64: form
A V and B V and one k x k Gram matrix, 3 x 2 n^2 k operations (2 x 2 n^2 k
for a standard problem, B V absent) at the FP64 tensor-core peak; or the
bytes of A and B read once and of V read and written once at the memory
rate, whichever takes longer.  It counts the same work whatever
implements the refinement, so fewer steps, symmetric products or a
banded V J raise it, and no refinement can honestly pass 100 %."""

from ekbench import roofline
from ekbench.harness import say

F64 = 8


def bound_s(n: int, k: int, generalized: bool) -> float:
    mats = 2 if generalized else 1
    ops = (mats + 1) * 2.0 * n * n * k
    nbytes = (mats * n * n + 2 * n * k) * F64
    return max(ops / roofline.PEAK_FP64_TENSOR, nbytes / roofline.MEM_RATE)


def read(run):
    sec = run.stage_s("solve:refine")
    if not sec:
        return None
    bound = bound_s(run.n, run.n_vec,
                    run.cell.get("solver", "").startswith("general"))
    say(f"roofline refine: bound {bound} s, refine_s {sec} s")
    return 100.0 * bound / sec
