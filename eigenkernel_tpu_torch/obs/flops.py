"""Model flop counts of the one-stage pipeline's stages.

Counterpart of the one-stage part of ``eigenkernel_tpu/obs/flops.py``.
Each count is the useful arithmetic of the textbook algorithm, not the
executed instructions; ``log.json`` carries them as ``!<stage>_Gflops``
events (the reference re-logs backend GFLOPS self-reports the same way).
"""

from __future__ import annotations


def tridiagonalize(n: int) -> float:
    return 4 * n ** 3 / 3


def bisect_invit(n: int, k: int, iters: int = 62, invit_steps: int = 3):
    # Sturm scans: iters x O(n k); inverse iteration: invit x O(n k);
    # CholQR2: 2 x (2 n k^2)
    return float(2 * iters * n * k + 10 * invit_steps * n * k
                 + 4 * n * k * k)


def back_transform_one_stage(n: int, k: int) -> float:
    return 4.0 * n * n * k
