"""Result verification: residual norms, orthogonality, ipratios.

Counterpart of ``eigenkernel_tpu/verify/verifier.py`` (reference:
verifier.f90 + get_ipratios):

* ``eval_residual_norm``: ``R = A V - [B] V diag(lambda)``, per-column
  2-norms; returns ``(||A||_F, ave, max)`` with ave/max divided by
  ``||A||_F``.
* ``eval_orthogonality``: ``G = V^T [B] V`` over an index window, scaled
  ``G_ij / sqrt(G_ii G_jj)``, diagonal zeroed, Frobenius norm.
* ``get_ipratios``: ``sum_i v_ij^4 / (sum_i v_ij ([B] v)_ij)^2``.

``b`` (the generalized problem's B) gives the B-metric forms.  Products
run with TF32 off, so a float32 residual is a float32 residual.

Eigenpairs from a process grid (``EigenPairs.grid``: each rank its own
columns, ``a`` a DistMatrix) give the same numbers to rounding: each
rank's checked columns are broadcast in turn, ``A V`` of them is each
block's product summed over the grid and kept by their rank, each rank
forms its rows of ``V^T V``, and the sums and maxima are reduced over the
grid; no rank holds more than its own columns and one other rank's.
"""

from __future__ import annotations

import numpy as np
import torch

from eigenkernel_tpu_torch.core.config import set_matmul_precision_highest
from eigenkernel_tpu_torch.core.types import EigenPairs
from eigenkernel_tpu_torch.parallel import mesh as pm


def _times_b(b, v: torch.Tensor) -> torch.Tensor:
    """``B v``, or ``v`` without B."""
    if b is None:
        return v
    return torch.as_tensor(b).to(device=v.device, dtype=v.dtype) @ v


def eval_residual_norm(a, eigenpairs: EigenPairs, n_check: int, b=None):
    """Average and max of ``||A v - lambda [B] v||_2 / ||A||_F`` over the
    first ``n_check`` eigenpairs.  Returns (A_norm, ave, max) as floats."""
    set_matmul_precision_highest()
    if eigenpairs.grid is not None:
        return _residual_grid(a, eigenpairs, n_check)
    v = eigenpairs.vectors[:, :n_check]
    w = eigenpairs.values[:n_check]
    a = torch.as_tensor(a).to(device=v.device, dtype=v.dtype)
    norms = torch.linalg.vector_norm(a @ v - _times_b(b, v) * w[None, :],
                                     dim=0)
    a_norm = torch.linalg.matrix_norm(a)
    return (float(a_norm), float(norms.mean() / a_norm),
            float(norms.max() / a_norm))


def eval_orthogonality(eigenpairs: EigenPairs, index_start: int,
                       index_end: int, b=None) -> float:
    """``||offdiag(D^{-1/2} G D^{-1/2})||_F`` with ``G = V^T [B] V`` over
    eigenvector indices [index_start, index_end] (1-based, inclusive)."""
    set_matmul_precision_highest()
    if eigenpairs.grid is not None:
        return _orthogonality_grid(eigenpairs, index_start, index_end)
    v = eigenpairs.vectors[:, index_start - 1:index_end]
    g = v.T @ _times_b(b, v)
    dg = g.diagonal().abs().sqrt()
    gs = g / torch.outer(dg, dg)
    gs = gs - torch.diag(gs.diagonal())
    return float(torch.linalg.matrix_norm(gs))


def get_ipratios(eigenpairs: EigenPairs, b=None) -> np.ndarray:
    """Inverse participation ratios of the eigenvectors (B-metric with
    ``b``).  Returns a host float64 array of length n_vec."""
    set_matmul_precision_highest()
    v = eigenpairs.vectors
    s2 = (v * _times_b(b, v)).sum(dim=0)
    ipr = (v ** 4).sum(dim=0) / (s2 * s2)
    if eigenpairs.grid is not None:
        ipr = pm.gather_slots(ipr, eigenpairs.cols,
                              (eigenpairs.values.shape[0],), eigenpairs.grid)
    return ipr.double().cpu().numpy()


def _residual_grid(a: pm.DistMatrix, pairs: EigenPairs, n_check: int):
    grid = pairs.grid
    n = pairs.dim
    mine = pairs.cols < n_check
    v = pairs.vectors[:, mine]
    lam = pairs.values[pairs.cols[mine]]
    blk = a.local.to(v.dtype)
    nr, nc = blk.shape
    r0, c0 = a.row0, a.col0
    # the padding rows and columns of the blocks are cut
    rr, cc = min(nr, max(n - r0, 0)), min(nc, max(n - c0, 0))
    norms = v.new_zeros(0)
    for q, vq in pm.rank_shares(v, grid):
        if not vq.numel():
            continue
        # A v_q: each block's product, summed over the grid
        av = torch.zeros_like(vq)
        if rr > 0 and cc > 0:
            av[r0:r0 + rr] = blk[:rr, :cc] @ vq[c0:c0 + cc]
        pm.all_reduce(av, grid)
        if q == grid.rank:
            norms = torch.linalg.vector_norm(av - v * lam[None, :], dim=0)
    sq = pm.all_reduce((blk[:rr, :cc] ** 2).sum().reshape(1), grid)
    a_norm = torch.sqrt(sq[0])
    tot = pm.all_reduce(norms.sum().reshape(1), grid)
    top = pm.all_reduce(norms.max().reshape(1) if norms.numel() else
                        norms.new_zeros(1), grid, op="max")
    return (float(a_norm), float(tot[0] / n_check / a_norm),
            float(top[0] / a_norm))


def _orthogonality_grid(pairs: EigenPairs, index_start: int,
                        index_end: int) -> float:
    grid = pairs.grid
    mine = (pairs.cols >= index_start - 1) & (pairs.cols < index_end)
    v = pairs.vectors[:, mine]
    dg = torch.linalg.vector_norm(v, dim=0)
    tot = v.new_zeros(1)
    for q, vq in pm.rank_shares(v, grid):
        # this rank's rows of G against rank q's columns; a column is on
        # one rank, so G's diagonal lies in this rank's own block
        g = (v.T @ vq) / torch.outer(dg, torch.linalg.vector_norm(vq, dim=0))
        if q == grid.rank:
            g.fill_diagonal_(0.0)
        tot += (g * g).sum()
    pm.all_reduce(tot, grid)
    return float(torch.sqrt(tot[0]))
