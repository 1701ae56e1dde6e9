"""Model flop counts of the SEP cores' stages.

Counterpart of the one- and two-stage parts of
``eigenkernel_tpu/obs/flops.py``.
Each count is the useful arithmetic of the textbook algorithm, not the
executed instructions; ``log.json`` carries them as ``!<stage>_Gflops``
events (the reference re-logs backend GFLOPS self-reports the same way).
"""

from __future__ import annotations


def tridiagonalize(n: int) -> float:
    return 4 * n ** 3 / 3


def full_to_band(n: int, bw: int) -> float:
    return 4 * n ** 3 / 3


def band_to_tridiag(n: int, bw: int) -> float:
    # ~n sweeps x (n/bw windows) x two-sided rank-1 on (bw, 3bw) tiles
    return 12.0 * n * n * bw


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
