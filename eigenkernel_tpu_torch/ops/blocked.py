"""Dense helpers shared by the cores and the generalized reductions.

Counterpart of ``eigenkernel_tpu/ops/blocked.py``:

* ``blocked_cholesky``          <- pdpotrf
* ``invert_lower_triangular``   <- ELPA ``invert_triangular``
* ``trsm_lower``                <- pdtrtrs / pdtrsm
* ``trsm_right_lower_t``        <- the right-side solve ``X L^T = B``
* ``symmetrize``                <- (A + A^T) / 2

The JAX package's recursive block bisections exist to bound the number
of XLA shapes; here each is one ``torch.linalg`` call (cuSOLVER and
cuBLAS on the card) on any n.
"""

from __future__ import annotations

import torch


class NotPositiveDefiniteError(ValueError):
    pass


def blocked_cholesky(g: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD ``g`` (pdpotrf analog); raises when the
    factorization breaks down instead of handing NaNs on."""
    l, info = torch.linalg.cholesky_ex(g)
    bad = int(info)
    if bad != 0:
        raise NotPositiveDefiniteError(
            f"cholesky: leading minor {bad} of the {g.shape[0]}x{g.shape[0]} "
            f"matrix is not positive definite")
    return l


def invert_lower_triangular(l: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of a lower-triangular matrix (ELPA
    invert_triangular analog)."""
    eye = torch.eye(l.shape[0], dtype=l.dtype, device=l.device)
    return torch.linalg.solve_triangular(l, eye, upper=False)


def trsm_lower(l: torch.Tensor, b: torch.Tensor, *,
               transpose: bool = False) -> torch.Tensor:
    """Solve ``L X = B``, or ``L^T X = B`` when ``transpose``, with L lower
    triangular (pdtrsm / pdtrtrs analog)."""
    if transpose:
        return torch.linalg.solve_triangular(l.T, b, upper=True)
    return torch.linalg.solve_triangular(l, b, upper=False)


def trsm_right_lower_t(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``X L^T = B`` (right side) with L lower triangular."""
    return torch.linalg.solve_triangular(l.T, b, upper=True, left=False)


def symmetrize(a: torch.Tensor) -> torch.Tensor:
    """(A + A^T) / 2, to keep two-sided products numerically symmetric."""
    return (a + a.T) * 0.5


def gershgorin_sentinel(a: torch.Tensor) -> torch.Tensor:
    """Value strictly above the spectrum of symmetric ``a`` (Gershgorin
    bound + margin), the JAX package's padding-diagonal convention: padded
    eigenpairs then sort strictly last."""
    radius = a.abs().sum(dim=1)
    diag = a.diagonal()
    hi = (diag + radius).max()
    lo = (diag - radius).min()
    return hi + 0.125 * torch.clamp(hi - lo, min=1.0) + 1.0
