"""Generalized -> standard reduction and eigenvector recovery.

Counterpart of ``eigenkernel_tpu/ops/reduction.py``.  For the pencil
``A x = lambda B x`` with ``B = L L^T`` SPD:

    A_std = L^{-1} A L^{-T},      A_std y = lambda y,      x = L^{-T} y.

* ``reduce_scalapack`` (pdpotrf + pdsygst): Cholesky and two triangular
  solves.
* ``reduce_scalapack_new`` (pdpotrf + pdsyngst): the half-matrix form,
  ``S = L^{-1} T L^{-T}`` with ``T`` = strict lower triangle + half the
  diagonal, then ``A_std = S + S^T``.
* ``reduce_elpa`` (ELPA): Cholesky, the explicit inverse ``R = L^{-1}``
  and two matrix products.
* ``recover``: ``x = L^{-T} y`` by a triangular solve (scalapack style)
  or ``x = R^T y`` by a product (elpa style).  The vectors come out
  B-orthonormal (x^T B x = y^T y = I), the dsygv convention.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eigenkernel_tpu_torch.ops.blocked import (blocked_cholesky,
                                               invert_lower_triangular,
                                               symmetrize, trsm_lower,
                                               trsm_right_lower_t)


class Reduction(NamedTuple):
    a_std: torch.Tensor     # L^{-1} A L^{-T}
    factor: torch.Tensor    # L (scalapack style) or R = L^{-1} (elpa style)
    style: str              # 'scalapack' | 'elpa'


def reduce_scalapack(a: torch.Tensor, b: torch.Tensor) -> Reduction:
    """pdpotrf + pdsygst analog: A_std = L^{-1} A L^{-T} by two solves."""
    l = blocked_cholesky(b)
    w = trsm_lower(l, a)                       # L^{-1} A
    a_std = trsm_right_lower_t(l, w)           # ... L^{-T}
    return Reduction(a_std=symmetrize(a_std), factor=l, style="scalapack")


def reduce_scalapack_new(a: torch.Tensor, b: torch.Tensor) -> Reduction:
    """pdpotrf + pdsyngst analog: with ``A = T + T^T`` (T = strict lower +
    half diagonal), ``S = L^{-1} T L^{-T}`` and ``A_std = S + S^T``."""
    l = blocked_cholesky(b)
    t = torch.tril(a, -1) + torch.diag(a.diagonal() / 2)
    s = trsm_right_lower_t(l, trsm_lower(l, t))
    return Reduction(a_std=s + s.T, factor=l, style="scalapack")


def reduce_elpa(a: torch.Tensor, b: torch.Tensor) -> Reduction:
    """ELPA-style reduction: explicit inverse and two products."""
    l = blocked_cholesky(b)
    r = invert_lower_triangular(l)             # R = L^{-1}
    a_std = (r @ a) @ r.T
    return Reduction(a_std=symmetrize(a_std), factor=r, style="elpa")


def recover(red: Reduction, y: torch.Tensor) -> torch.Tensor:
    """Back-transform standard-problem eigenvectors: ``x = L^{-T} y``."""
    if red.style == "scalapack":
        return trsm_lower(red.factor, y, transpose=True)
    return red.factor.T @ y
