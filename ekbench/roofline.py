"""Kernel bounds on one H100: a frozen copy of the port's
``obs/flops.py`` (``bound_chase``, ``bound_wf_bt`` and what they call,
with B4's plan from ``ops/wf_bt.py::plan_of`` at its default group),
kept here so that a change to the program cannot move the yardstick.

A bound is the least time the card could take for a kernel's work: the
larger of its operations over the peak rate for their type and its bytes
(each input read once, each output written once) over the memory rate.
Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit.
"""

from __future__ import annotations

PEAK_FP64_TENSOR = 67e12
PEAK_FP64 = 34e12
PEAK_FP32 = 67e12
MEM_RATE = 3.35e12
WF_BT_GROUP = 64   # B4's sweeps a group (EK_BT_GROUP unset)


def _bound(ops: float, nbytes: float, peak: float):
    """(ms, "operations" or "bytes")."""
    t_ops, t_bytes = ops / peak, nbytes / MEM_RATE
    if t_ops >= t_bytes:
        return 1e3 * t_ops, "operations"
    return 1e3 * t_bytes, "bytes"


def _cuda_core_peak(itemsize: int) -> float:
    return PEAK_FP64 if itemsize == 8 else PEAK_FP32


def chase_live_lanes(n: int, b: int) -> int:
    """Live (sweep, position) steps of the chase: sweep c at position t is
    live while its window starts before row n - 1, c + 1 + t b < n - 1."""
    T = n // b + 2
    return sum(max(0, n - 2 - t * b) for t in range(T))


def bound_chase(n: int, b: int, itemsize: int):
    """B3: per live lane three matrix-vector products (D v, v^T L, F v) and
    the matching updates, 12 b^2 operations; reads and writes the
    (n + 2b) x (2b + 1) state, writes b + 1 reflector words a lane."""
    lanes = chase_live_lanes(n, b)
    nbytes = (2 * (n + 2 * b) * (2 * b + 1) + lanes * (b + 1)) * itemsize
    return _bound(12.0 * b * b * lanes, nbytes, _cuda_core_peak(itemsize))


def wf_bt_plan(n: int, b: int, g: int = WF_BT_GROUP):
    """(g, m, nG, Tm, Tq2) of B4's plan: T = n // b + 2 band positions,
    groups of g sweeps, m positions a composite step."""
    T = n // b + 2
    g = min(g, n - 2)
    nG = -(-(n - 2) // g)
    m = max(1, min((128 - (b + g)) // b + 1, T))
    Tm = -(-T // m)
    return g, m, nG, Tm, Tm + nG - 1


def wf_bt_lane_steps(n: int, b: int, g: int = WF_BT_GROUP):
    """(launches, live lane-steps) of B4 over all its composite steps: per
    step u the live groups are max(0, u - Tm + 1,
    floor((m b u + n - 1 - g - n) / S2) + 1) .. min(nG - 1, u)."""
    g, m, nG, Tm, Tq2 = wf_bt_plan(n, b, g)
    S2 = g + m * b
    K = n - 1 - g
    launches = steps = 0
    for u in range(Tq2):
        lo = max(0, u - Tm + 1, (m * b * u + K - n) // S2 + 1)
        hi = min(nG - 1, u)
        if hi >= lo:
            launches += 1
            steps += hi - lo + 1
    return launches, steps


def bound_wf_bt(n: int, k: int, b: int, itemsize: int,
                g: int = WF_BT_GROUP):
    """B4: 2 S2^2 k operations per live lane-step; reads its S2 x S2
    transform once, reads and writes z once (n x k).  float64 on the
    tensor cores.  Returns (ms, bound_by, launches, lane_steps)."""
    g, m, _, _, _ = wf_bt_plan(n, b, g)
    S2 = g + m * b
    launches, steps = wf_bt_lane_steps(n, b, g)
    peak = PEAK_FP64_TENSOR if itemsize == 8 else PEAK_FP32
    ms, by = _bound(2.0 * S2 * S2 * k * steps,
                    (steps * S2 * S2 + 2 * n * k) * itemsize, peak)
    return ms, by, launches, steps
