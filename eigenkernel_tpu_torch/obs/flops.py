"""Model flop counts of the SEP cores' stages, and the bounds of the
port's kernels on the card.

The stage counts are copied from ``eigenkernel_tpu/obs/flops.py``: the
reductions and the recovery of generalized problems, the one- and
two-stage cores, divide and conquer and the ``eigh`` core.
Each count is the useful arithmetic of the textbook algorithm, not the
executed instructions; ``log.json`` carries them as ``!<stage>_Gflops``
events (the reference re-logs backend GFLOPS self-reports the same way).
"""

from __future__ import annotations

from eigenkernel_tpu_torch.ops import wf_bt


def cholesky(n: int) -> float:
    return n ** 3 / 3


def invert_triangular(n: int) -> float:
    return n ** 3 / 3


def trmm(n: int, k: int) -> float:
    """Triangular (n,n) times (n,k): n^2 k madds -> n^2 k flops."""
    return float(n * n * k)


def reduce_elpa(n: int) -> float:
    # cholesky + invert + U^-T A (trmm) + A U^-1 (trmm)
    return cholesky(n) + invert_triangular(n) + 2 * trmm(n, n)


def reduce_scalapack(n: int) -> float:
    # cholesky + two triangular solves against (n, n)
    return cholesky(n) + 2 * trmm(n, n)


def tridiagonalize(n: int) -> float:
    return 4 * n ** 3 / 3


def full_to_band(n: int, bw: int) -> float:
    return 4 * n ** 3 / 3


def band_to_tridiag(n: int, bw: int) -> float:
    # ~n sweeps x (n/bw windows) x two-sided rank-1 on (bw, 3bw) tiles
    return 12.0 * n * n * bw


def tridiag_dc(n: int) -> float:
    # merge-tree eigenvector GEMMs: sum_l n K_l^2 ~ (4/3) n^3 madds
    return 8 * n ** 3 / 3


def tridiag_eigh(n: int, k: int) -> float:
    """The ``sep:tridiag_eigh`` model of both cores: divide and conquer's
    for half the spectrum or more, else bisection and inverse
    iteration's, whichever tridiagonal core ran (the JAX package's rule)."""
    return tridiag_dc(n) if 2 * k >= n else bisect_invit(n, k)


def bisect_invit(n: int, k: int, iters: int = 62, invit_steps: int = 3):
    # Sturm scans: iters x O(n k); inverse iteration: invit x O(n k);
    # CholQR2: 2 x (2 n k^2)
    return float(2 * iters * n * k + 10 * invit_steps * n * k
                 + 4 * n * k * k)


def back_transform_one_stage(n: int, k: int) -> float:
    return 4.0 * n * n * k


def back_transform_two_stage(n: int, k: int) -> float:
    # chase-Q (4 n^2 k) + band-Q (4 n^2 k)
    return 8.0 * n * n * k


def recover(n: int, k: int) -> float:
    return trmm(n, k)


def jacobi(n: int, sweeps: int = 8) -> float:
    # 3 batched rotation GEMM passes per tournament round, n/b rounds
    return 12.0 * sweeps * n ** 3


def qdwh_dc(n: int) -> float:
    # per split node at size m: ~7-iteration sign (QR iters ~5 m^3, chol
    # iters ~3 m^3 each -> ~22 m^3) + CholQR2 (~5 m^3) + rotation GEMMs
    # (4 m^3) + vector assembly (2 m^3) ~ 33 m^3; the balanced tree sums
    # sum_l 2^l (m/2^l)^3 = m^3 / (1 - 1/4) -> ~44 n^3
    return 44.0 * n ** 3


def eigh(n: int) -> float:
    # dense symmetric eigensolver nominal count (the LAPACK-style
    # 4/3 n^3 + 4 n^3)
    return 16 * n ** 3 / 3


# ---- kernel bounds on the card ----------------------------------------------
# The least time an H100 SXM could take for a kernel's work: the larger of
# its operations over the peak rate for their type and its bytes (each
# input read once, each output written once) over the memory rate.  Peaks
# (NVIDIA's data sheet, dense, at the 700 W limit): 67 TFLOP/s FP64 on the
# tensor cores and FP32 on the CUDA cores, 34 TFLOP/s FP64 on the CUDA
# cores, 3.35 TB/s.  The two back-transforms (B4, B5) can run as matrix
# products, so their float64 work is held to the tensor-core rate; the
# scalar recurrences (B1, B2) and the chase's matrix-vector products and
# rank-one updates (B3) are held to the CUDA-core rate of their type.  D1,
# a serial recurrence of K steps a merge, is held to its chain: K steps of
# one step's measured latency (tools/div_chain.py), its operations taken
# one after another; D2 to the larger of its rotations' operations and its
# chain of dependent sets, each of one set's measured latency.

PEAK_FP64_TENSOR = 67e12
PEAK_FP64 = 34e12
PEAK_FP32 = 67e12
MEM_RATE = 3.35e12


def _bound(ops: float, nbytes: float, peak: float):
    """(ms, "operations" or "bytes")."""
    t_ops, t_bytes = ops / peak, nbytes / MEM_RATE
    if t_ops >= t_bytes:
        return 1e3 * t_ops, "operations"
    return 1e3 * t_bytes, "bytes"


def _cuda_core_peak(dtype) -> float:
    return PEAK_FP64 if dtype.itemsize == 8 else PEAK_FP32


def chase_live_lanes(n: int, b: int) -> int:
    """Live (sweep, position) steps of the chase: sweep c at position t is
    live while its window starts before row n - 1, c + 1 + t b < n - 1."""
    T = n // b + 2
    return sum(max(0, n - 2 - t * b) for t in range(T))


def wf_bt_lane_steps(pl, u0: int = 0, u1=None):
    """(launches, live lane-steps) of B4 over composite steps [u0, u1) of
    the plan ``pl`` (``ops/wf_bt.py``): per step u the live groups are
    max(0, u - Tm + 1, floor((m b u + n - 1 - g - n) / S2) + 1) ..
    min(nG - 1, u)."""
    S2 = pl.g + pl.m * pl.b
    K = pl.n - 1 - pl.g
    launches = steps = 0
    for u in range(u0, pl.Tq2 if u1 is None else u1):
        lo = max(0, u - pl.Tm + 1, (pl.m * pl.b * u + K - pl.n) // S2 + 1)
        hi = min(pl.nG - 1, u)
        if hi >= lo:
            launches += 1
            steps += hi - lo + 1
    return launches, steps


def bound_sturm(n: int, k: int, iters: int, dtype):
    """B1: k targets x iters Sturm counts of n steps (subtract, divide,
    subtract); reads d, e^2, the indices and bounds, writes k values."""
    isz = dtype.itemsize
    return _bound(3.0 * n * iters * k, (2 * n + 2 + k) * isz + 4 * k,
                  _cuda_core_peak(dtype))


def bound_solve(n: int, k: int, dtype):
    """B2: k shifted tridiagonal solves, 6 operations a row forward and 3
    back; reads d, e, the shifts and b (n x k), writes x (n x k)."""
    isz = dtype.itemsize
    return _bound(9.0 * n * k, (2 * n + k + 2 * n * k) * isz,
                  _cuda_core_peak(dtype))


def bound_chase(n: int, b: int, dtype):
    """B3: per live lane three matrix-vector products (D v, v^T L, F v) and
    the matching updates, 12 b^2 operations; reads and writes the
    (n + 2b) x (2b + 1) state, writes b + 1 reflector words a lane."""
    isz = dtype.itemsize
    lanes = chase_live_lanes(n, b)
    nbytes = (2 * (n + 2 * b) * (2 * b + 1) + lanes * (b + 1)) * isz
    return _bound(12.0 * b * b * lanes, nbytes, _cuda_core_peak(dtype))


def bound_wf_bt(n: int, k: int, b: int, g: int, dtype, u0: int = 0,
                u1=None):
    """B4 over composite steps [u0, u1): 2 S2^2 k operations per live
    lane-step; reads its S2 x S2 transform once, reads and writes z once
    (n x k).  Returns (ms, bound_by, launches, lane_steps)."""
    isz = dtype.itemsize
    pl = wf_bt.plan_of(n, b, n // b + 2, isz, g)
    S2 = pl.g + pl.m * pl.b
    launches, steps = wf_bt_lane_steps(pl, u0, u1)
    peak = PEAK_FP64_TENSOR if isz == 8 else PEAK_FP32
    ms, by = _bound(2.0 * S2 * S2 * k * steps,
                    (steps * S2 * S2 + 2 * n * k) * isz, peak)
    return ms, by, launches, steps


def bound_chase_bt(n: int, k: int, b: int, dtype):
    """B5: every live reflector (length b) applied to z, 4 b k operations
    (the function's work, not the larger count of its WY form); reads the
    reflectors and taus, reads and writes z (n x k).  float64 at the
    tensor-core peak, as B4."""
    isz = dtype.itemsize
    refl = chase_live_lanes(n, b)
    return _bound(4.0 * b * k * refl, (refl * (b + 1) + 2 * n * k) * isz,
                  PEAK_FP64_TENSOR if isz == 8 else PEAK_FP32)


def bound_deflate(nb: int, K: int, dtype, step_ns: float,
                  close_steps: int):
    """D1 on one level of nb merges of K steps: the larger of its bytes
    (reads the poles, weights, type-1 mask and tolerances; writes four
    value planes, four index planes, two flag planes and the carries) over
    the memory rate and its chain: ``close_steps`` (the most close steps of
    any merge of the level) dependent steps of ``step_ns`` each.  Only a
    close step passes on a carry computed from the one before it (an alive
    step that is not close resets the carry to its own inputs), so no
    order of evaluation avoids that chain, and the merges run side by
    side."""
    isz = dtype.itemsize
    nbytes = nb * K * (2 * isz + 1) + nb * isz \
        + nb * K * (4 * isz + 4 * 8 + 2) + nb * (2 * isz + 8 + 1)
    t_chain, t_bytes = close_steps * step_ns * 1e-9, nbytes / MEM_RATE
    if t_chain >= t_bytes:
        return 1e3 * t_chain, "operations"
    return 1e3 * t_bytes, "bytes"


def bound_pair_eigh(m: int, w: int, sweeps: int, rotations: int, dtype,
                    set_ns: float):
    """D2 on m blocks of w x w: the largest of its operations over the
    CUDA-core peak of its type (18 w for each of the ``rotations`` the run
    applied: the rows, the columns and V^T, a product pair and a sum an
    entry), its bytes (reads the blocks; writes the values, the vectors
    and two counts a block) over the memory rate, and its chain:
    ``sweeps`` (the most any block ran) sweeps of w - 1 (w for odd w)
    dependent sets of ``set_ns`` each, the blocks side by side."""
    isz = dtype.itemsize
    sets = w - 1 + (w & 1)
    ops = 18.0 * w * rotations
    nbytes = (2 * m * w * w + m * w) * isz + 8 * m
    t_ops = max(ops / _cuda_core_peak(dtype), sweeps * sets * set_ns * 1e-9)
    t_bytes = nbytes / MEM_RATE
    if t_ops >= t_bytes:
        return 1e3 * t_ops, "operations"
    return 1e3 * t_bytes, "bytes"
