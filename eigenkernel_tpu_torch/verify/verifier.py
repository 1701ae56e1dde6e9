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
columns, ``a`` and ``b`` DistMatrix) give the same numbers to rounding:
each rank's checked columns are broadcast in turn, ``A V`` and ``B V`` of
them are each block's products summed over the grid (one ``all_reduce``)
and kept by their rank, each rank forms its rows of ``V^T B V``, and the
sums and maxima are reduced over the grid; no rank holds more than its
own columns and one other rank's.
"""

from __future__ import annotations

from typing import Optional

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
        return _residual_grid(a, eigenpairs, n_check, b)
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
        return _orthogonality_grid(eigenpairs, index_start, index_end, b)
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
    if eigenpairs.grid is not None and b is not None:
        bv = v
        for q, _, prods in _grid_products([b], eigenpairs,
                                          torch.ones_like(eigenpairs.cols,
                                                          dtype=torch.bool)):
            if q == eigenpairs.grid.rank:
                bv = prods[0]
    else:
        bv = _times_b(b, v)
    s2 = (v * bv).sum(dim=0)
    ipr = (v ** 4).sum(dim=0) / (s2 * s2)
    if eigenpairs.grid is not None:
        ipr = pm.gather_slots(ipr, eigenpairs.cols,
                              (eigenpairs.values.shape[0],), eigenpairs.grid)
    return ipr.double().cpu().numpy()


def _grid_products(mats, pairs: EigenPairs, mine: torch.Tensor):
    """Yield ``(q, v_q, [M v_q for M in mats])`` for every grid rank q in
    turn, ``v_q`` rank q's columns ``mine`` of its eigenvectors and the
    products whole (n rows): each block's products summed over the grid
    by one ``all_reduce``.  The padding rows and columns of the blocks
    are cut."""
    grid = pairs.grid
    n = pairs.dim
    v = pairs.vectors[:, mine]
    for q, vq in pm.rank_shares(v, grid):
        if not vq.numel():
            yield q, vq, [vq] * len(mats)
            continue
        k = vq.shape[1]
        out = vq.new_zeros((n, k * len(mats)))
        for i, m in enumerate(mats):
            blk = m.local.to(vq.dtype)
            nr, nc = blk.shape
            rr = min(nr, max(n - m.row0, 0))
            cc = min(nc, max(n - m.col0, 0))
            if rr > 0 and cc > 0:
                out[m.row0:m.row0 + rr, i * k:(i + 1) * k] = \
                    blk[:rr, :cc] @ vq[m.col0:m.col0 + cc]
        pm.all_reduce(out, grid)
        yield q, vq, [out[:, i * k:(i + 1) * k] for i in range(len(mats))]


def _residual_grid(a: pm.DistMatrix, pairs: EigenPairs, n_check: int,
                   b: Optional[pm.DistMatrix] = None):
    grid = pairs.grid
    n = pairs.dim
    mine = pairs.cols < n_check
    v = pairs.vectors[:, mine]
    lam = pairs.values[pairs.cols[mine]]
    norms = v.new_zeros(0)
    mats = [a] if b is None else [a, b]
    for q, _, prods in _grid_products(mats, pairs, mine):
        if q == grid.rank:
            bv = v if b is None else prods[1]
            norms = torch.linalg.vector_norm(prods[0] - bv * lam[None, :],
                                             dim=0)
    blk = a.local.to(v.dtype)
    rr = min(blk.shape[0], max(n - a.row0, 0))
    cc = min(blk.shape[1], max(n - a.col0, 0))
    sq = pm.all_reduce((blk[:rr, :cc] ** 2).sum().reshape(1), grid)
    a_norm = torch.sqrt(sq[0])
    tot = pm.all_reduce(norms.sum().reshape(1), grid)
    top = pm.all_reduce(norms.max().reshape(1) if norms.numel() else
                        norms.new_zeros(1), grid, op="max")
    return (float(a_norm), float(tot[0] / n_check / a_norm),
            float(top[0] / a_norm))


def _orthogonality_grid(pairs: EigenPairs, index_start: int, index_end: int,
                        b: Optional[pm.DistMatrix] = None) -> float:
    grid = pairs.grid
    mine = (pairs.cols >= index_start - 1) & (pairs.cols < index_end)
    v = pairs.vectors[:, mine]
    if b is None:
        shares = ((q, vq, vq) for q, vq in pm.rank_shares(v, grid))
    else:
        shares = ((q, vq, prods[0])
                  for q, vq, prods in _grid_products([b], pairs, mine))
    dg = None
    # this rank's rows of G = V^T B V against rank q's columns, scaled by
    # the columns' norms; the rows' own norms divide at the end (a column
    # is on one rank, so G's diagonal lies in this rank's own block)
    rows = v.new_zeros(v.shape[1])
    for q, vq, bvq in shares:
        dq = (vq * bvq).sum(dim=0).abs().sqrt()
        g = (v.T @ bvq) / dq[None, :]
        if q == grid.rank:
            g.fill_diagonal_(0.0)
            dg = dq
        rows += (g * g).sum(dim=1)
    tot = (rows / (dg * dg)).sum().reshape(1)
    pm.all_reduce(tot, grid)
    return float(torch.sqrt(tot[0]))
