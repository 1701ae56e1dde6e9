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

from eigenkernel_tpu_torch.parallel import mesh as pm


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


def gershgorin_sentinel(a, mesh=None) -> torch.Tensor:
    """Value strictly above the spectrum of symmetric ``a`` (Gershgorin
    bound + margin), the JAX package's padding-diagonal convention: padded
    eigenpairs then sort strictly last.

    With ``mesh``, ``a`` is a DistMatrix on it: the row sums and the
    diagonal of this rank's rows are summed over its process row, the
    bounds taken over the logical rows of the whole grid."""
    if mesh is None:
        radius = a.abs().sum(dim=1)
        diag = a.diagonal()
        hi = (diag + radius).max()
        lo = (diag - radius).min()
        return hi + 0.125 * torch.clamp(hi - lo, min=1.0) + 1.0
    blk = a.local
    nr, nc = blk.shape
    rows = torch.arange(a.row0, a.row0 + nr, device=blk.device)
    radius = pm.all_reduce(blk.abs().sum(dim=1), mesh, over="row")
    at = rows - a.col0                 # each row's diagonal column here
    here = (at >= 0) & (at < nc)
    diag = torch.zeros_like(radius)
    diag[here] = blk[here, at[here]]
    pm.all_reduce(diag, mesh, over="row")
    real = rows < a.n
    ninf = torch.tensor(-torch.inf, dtype=blk.dtype, device=blk.device)
    bounds = torch.stack([torch.where(real, diag + radius, ninf).max(),
                          torch.where(real, radius - diag, ninf).max()])
    pm.all_reduce(bounds, mesh, op="max")
    hi, lo = bounds[0], -bounds[1]
    return hi + 0.125 * torch.clamp(hi - lo, min=1.0) + 1.0
