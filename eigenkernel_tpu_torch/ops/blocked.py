"""Dense helpers shared by the cores.

Counterpart of the parts of ``eigenkernel_tpu/ops/blocked.py`` that the
one-stage selecting path needs.  The JAX package's recursive-bisection
Cholesky and TRSM exist to bound the number of XLA shapes; here they are
single ``torch.linalg`` calls.
"""

from __future__ import annotations

import torch


class NotPositiveDefiniteError(ValueError):
    pass


def cholesky_lower(g: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD ``g``; raises when the factorization
    breaks down instead of handing NaNs on."""
    l, info = torch.linalg.cholesky_ex(g)
    bad = int(info)
    if bad != 0:
        raise NotPositiveDefiniteError(
            f"cholesky: leading minor {bad} of the {g.shape[0]}x{g.shape[0]} "
            f"matrix is not positive definite")
    return l


def gershgorin_sentinel(a: torch.Tensor) -> torch.Tensor:
    """Value strictly above the spectrum of symmetric ``a`` (Gershgorin
    bound + margin), the JAX package's padding-diagonal convention: padded
    eigenpairs then sort strictly last."""
    radius = a.abs().sum(dim=1)
    diag = a.diagonal()
    hi = (diag + radius).max()
    lo = (diag - radius).min()
    return hi + 0.125 * torch.clamp(hi - lo, min=1.0) + 1.0
