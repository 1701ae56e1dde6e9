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

On a process grid (``mesh=``; A, B, the factor and ``a_std``
:class:`~eigenkernel_tpu_torch.parallel.mesh.DistMatrix`) the same
formulas run on the grid's Cholesky, solves and products
(:mod:`.blocked`, ``parallel.mesh.matmul`` / ``transpose``), panel width
``block``; ``recover`` takes a rank's own eigenvector columns, whole
rows (the core's ``ColumnShares.vectors``), and applies ``L^{-T}`` (or
``R^T``) by gathering the factor's block-row panels in turn, the way
``householder.apply_q`` broadcasts its WY groups: no rank holds the
factor whole.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from eigenkernel_tpu_torch.ops.blocked import (GEMM_BLOCK, blocked_cholesky,
                                               invert_lower_triangular,
                                               symmetrize, trsm_lower,
                                               trsm_right_lower_t)
from eigenkernel_tpu_torch.parallel import mesh as pm


class Reduction(NamedTuple):
    a_std: Any              # L^{-1} A L^{-T}
    factor: Any             # L (scalapack style) or R = L^{-1} (elpa style)
    style: str              # 'scalapack' | 'elpa'


def reduce_scalapack(a, b, mesh: Optional[pm.ProcessGrid] = None,
                     block: int = GEMM_BLOCK) -> Reduction:
    """pdpotrf + pdsygst analog: A_std = L^{-1} A L^{-T} by two solves."""
    l = blocked_cholesky(b, block, mesh)
    w = trsm_lower(l, a, block=block, mesh=mesh)            # L^{-1} A
    a_std = trsm_right_lower_t(l, w, block=block, mesh=mesh)  # ... L^{-T}
    return Reduction(a_std=symmetrize(a_std), factor=l, style="scalapack")


def reduce_scalapack_new(a, b, mesh: Optional[pm.ProcessGrid] = None,
                         block: int = GEMM_BLOCK) -> Reduction:
    """pdpotrf + pdsyngst analog: with ``A = T + T^T`` (T = strict lower +
    half diagonal), ``S = L^{-1} T L^{-T}`` and ``A_std = S + S^T``."""
    l = blocked_cholesky(b, block, mesh)
    if mesh is None:
        t = torch.tril(a, -1) + torch.diag(a.diagonal() / 2)
    else:
        rows, cols = pm.global_index(a)
        t = a.with_local(torch.where(cols < rows, a.local, torch.where(
            cols == rows, a.local / 2, torch.zeros_like(a.local))))
    s = trsm_right_lower_t(l, trsm_lower(l, t, block=block, mesh=mesh),
                           block=block, mesh=mesh)
    if mesh is None:
        return Reduction(a_std=s + s.T, factor=l, style="scalapack")
    return Reduction(a_std=s.with_local(s.local + pm.transpose(s).local),
                     factor=l, style="scalapack")


def reduce_elpa(a, b, mesh: Optional[pm.ProcessGrid] = None,
                block: int = GEMM_BLOCK) -> Reduction:
    """ELPA-style reduction: explicit inverse and two products."""
    l = blocked_cholesky(b, block, mesh)
    r = invert_lower_triangular(l, block, mesh)          # R = L^{-1}
    if mesh is None:
        a_std = (r @ a) @ r.T
    else:
        a_std = pm.matmul(pm.matmul(r, a, panel=block), r, trans_b=True,
                          panel=block)
    return Reduction(a_std=symmetrize(a_std), factor=r, style="elpa")


def recover(red: Reduction, y: torch.Tensor,
            mesh: Optional[pm.ProcessGrid] = None,
            block: int = GEMM_BLOCK) -> torch.Tensor:
    """Back-transform standard-problem eigenvectors: ``x = L^{-T} y``.  On
    a grid ``y`` is this rank's columns, whole (n_m rows)."""
    if mesh is None:
        if red.style == "scalapack":
            return trsm_lower(red.factor, y, transpose=True)
        return red.factor.T @ y
    f = red.factor
    n = f.n_m
    starts = list(range(0, n, block))
    if red.style == "scalapack":
        # L^T x = y, row panels last to first: x_k = L_kk^{-T} y_k, then
        # y[:s] -= L[s:s+w, :s]^T x_k
        x = y.clone()
        for s in reversed(starts):
            w = min(block, n - s)
            lp = pm.gather_block(f, s, s + w, 0, s + w)
            xk = torch.linalg.solve_triangular(lp[:, s:].T, x[s:s + w],
                                               upper=True)
            x[s:s + w] = xk
            x[:s].addmm_(lp[:, :s].T, xk, alpha=-1.0)
        return x
    # x = R^T y = sum over row panels k of R[k, :s+w]^T y_k (R lower)
    x = torch.zeros_like(y)
    for s in starts:
        w = min(block, n - s)
        rp = pm.gather_block(f, s, s + w, 0, s + w)
        x[:s + w].addmm_(rp.T, y[s:s + w])
    return x
