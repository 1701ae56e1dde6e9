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

On a process grid (``mesh=``, every matrix a
:class:`~eigenkernel_tpu_torch.parallel.mesh.DistMatrix` of plain 2D
blocks) each is right-looking by panels of ``block`` columns, as pdpotrf
and pdtrsm are (the JAX package's GSPMD products, ``ops/blocked.py:51-150``,
written out).  The panel of the factor a step reads (its column block, or
for a transposed solve its row block) is gathered whole onto every rank
by one ``all_reduce`` (:func:`~eigenkernel_tpu_torch.parallel.mesh.gather_block`,
O(n block) words), its small triangle solved there, and each rank
updates its own block locally: one collective a panel for the Cholesky
factor, two for a solve (the right-hand side's panel is gathered along
the process column or row).  Every decision is taken on the gathered,
replicated panel, so a breakdown raises on every rank at the same step.
"""

from __future__ import annotations

from typing import Optional

import torch

from eigenkernel_tpu_torch.obs import events
from eigenkernel_tpu_torch.parallel import mesh as pm

GEMM_BLOCK = 256  # the grid's panel width (JAX DEFAULT_GEMM_BLOCK)


class NotPositiveDefiniteError(ValueError):
    pass


def _raise_if_broken(info, at: int, n: int) -> None:
    with events.span("wait:cholesky_info"):
        bad = int(info)
    if bad != 0:
        raise NotPositiveDefiniteError(
            f"cholesky: leading minor {at + bad} of the {n}x{n} matrix is "
            f"not positive definite")


def blocked_cholesky(g, block: int = GEMM_BLOCK,
                     mesh: Optional[pm.ProcessGrid] = None):
    """Lower Cholesky factor of SPD ``g`` (pdpotrf analog); raises when the
    factorization breaks down instead of handing NaNs on.  With ``mesh``,
    ``g`` and the factor are DistMatrix."""
    if mesh is not None:
        return _cholesky_grid(g, block)
    l, info = torch.linalg.cholesky_ex(g)
    _raise_if_broken(info, 0, g.shape[0])
    return l


def invert_lower_triangular(l, block: int = GEMM_BLOCK,
                            mesh: Optional[pm.ProcessGrid] = None):
    """Explicit inverse of a lower-triangular matrix (ELPA
    invert_triangular analog); on a grid ``L X = I`` by
    :func:`trsm_lower`."""
    if mesh is not None:
        return trsm_lower(l, pm.local_eye(l), block=block, mesh=mesh)
    eye = torch.eye(l.shape[0], dtype=l.dtype, device=l.device)
    return torch.linalg.solve_triangular(l, eye, upper=False)


def trsm_lower(l, b, *, transpose: bool = False, block: int = GEMM_BLOCK,
               mesh: Optional[pm.ProcessGrid] = None):
    """Solve ``L X = B``, or ``L^T X = B`` when ``transpose``, with L lower
    triangular (pdtrsm / pdtrtrs analog)."""
    if mesh is not None:
        return _trsm_left_grid(l, b, transpose, block)
    if transpose:
        return torch.linalg.solve_triangular(l.T, b, upper=True)
    return torch.linalg.solve_triangular(l, b, upper=False)


def trsm_right_lower_t(l, b, *, block: int = GEMM_BLOCK,
                       mesh: Optional[pm.ProcessGrid] = None):
    """Solve ``X L^T = B`` (right side) with L lower triangular."""
    if mesh is not None:
        return _trsm_right_grid(l, b, block)
    return torch.linalg.solve_triangular(l.T, b, upper=True, left=False)


def symmetrize(a):
    """(A + A^T) / 2, to keep two-sided products numerically symmetric."""
    if isinstance(a, pm.DistMatrix):
        return a.with_local((a.local + pm.transpose(a).local) * 0.5)
    return (a + a.T) * 0.5


def _cholesky_grid(a: pm.DistMatrix, block: int) -> pm.DistMatrix:
    """pdpotrf on plain blocks: per panel [s, s + w), the column block
    ``A[s:, s:s+w]`` whole on every rank; L11 = chol(A11) and
    L21 = A21 L11^{-T} there; each rank writes its part of the panel and
    updates its trailing block, ``A22 -= L21 L21^T``, locally."""
    A = a.local.clone()
    x = a.with_local(A)
    n = a.n_m
    for s in range(0, n, block):
        w = min(block, n - s)
        panel = pm.gather_block(x, s, n, s, s + w)
        l11, info = torch.linalg.cholesky_ex(panel[:w])
        _raise_if_broken(info, s, n)
        lp = torch.cat([l11, torch.linalg.solve_triangular(
            l11.T, panel[w:], upper=True, left=False)])
        a0, a1 = x.rows(s, n)
        b0, b1 = x.cols(s, s + w)
        if a1 > a0 and b1 > b0:
            A[a0:a1, b0:b1] = lp[x.row0 + a0 - s:x.row0 + a1 - s,
                                 x.col0 + b0 - s:x.col0 + b1 - s]
        a0, a1 = x.rows(s + w, n)
        b0, b1 = x.cols(s + w, n)
        if a1 > a0 and b1 > b0:
            l21 = lp[w:]
            A[a0:a1, b0:b1].addmm_(
                l21[x.row0 + a0 - s - w:x.row0 + a1 - s - w],
                l21[x.col0 + b0 - s - w:x.col0 + b1 - s - w].T, alpha=-1.0)
    rows, cols = pm.global_index(x)
    A.masked_fill_(cols > rows, 0.0)
    return x


def _trsm_left_grid(l: pm.DistMatrix, b: pm.DistMatrix, transpose: bool,
                    block: int) -> pm.DistMatrix:
    """pdtrsm, left side, on plain blocks, by row panels [s, s + w) (last
    to first when ``transpose``): the factor's panel whole on every rank
    (its column block ``L[s:, s:s+w]``, or its row block ``L[s:s+w, :s+w]``
    for ``L^T``), the right-hand side's rows ``B[s:s+w]`` of this rank's
    columns gathered along the process column, ``X_k`` solved there, and
    the rows still to solve updated locally."""
    X = b.local.clone()
    x = b.with_local(X)
    n = b.n_m
    nc = X.shape[1]
    starts = list(range(0, n, block))
    for s in (reversed(starts) if transpose else starts):
        w = min(block, n - s)
        if transpose:
            lp = pm.gather_block(l, s, s + w, 0, s + w)
            l11 = lp[:, s:]
        else:
            lp = pm.gather_block(l, s, n, s, s + w)
            l11 = lp[:w]
        bk = pm.gather_block(x, s, s + w, x.col0, x.col0 + nc, over="col")
        xk = torch.linalg.solve_triangular(l11.T, bk, upper=True) \
            if transpose else torch.linalg.solve_triangular(l11, bk,
                                                            upper=False)
        a0, a1 = x.rows(s, s + w)
        X[a0:a1] = xk[x.row0 + a0 - s:x.row0 + a1 - s]
        if transpose:
            a0, a1 = x.rows(0, s)
            if a1 > a0:
                X[a0:a1].addmm_(lp[:, x.row0 + a0:x.row0 + a1].T, xk,
                                alpha=-1.0)
        else:
            a0, a1 = x.rows(s + w, n)
            if a1 > a0:
                X[a0:a1].addmm_(lp[x.row0 + a0 - s:x.row0 + a1 - s], xk,
                                alpha=-1.0)
    return x


def _trsm_right_grid(l: pm.DistMatrix, b: pm.DistMatrix,
                     block: int) -> pm.DistMatrix:
    """``X L^T = B`` on plain blocks by column panels [s, s + w): the
    factor's column block whole on every rank, ``B[:, s:s+w]`` of this
    rank's rows gathered along the process row, ``X_k = B_k L11^{-T}``,
    and ``B[:, s+w:] -= X_k L21^T`` locally."""
    X = b.local.clone()
    x = b.with_local(X)
    n = b.n_m
    nr = X.shape[0]
    for s in range(0, n, block):
        w = min(block, n - s)
        lp = pm.gather_block(l, s, n, s, s + w)
        bk = pm.gather_block(x, x.row0, x.row0 + nr, s, s + w, over="row")
        xk = torch.linalg.solve_triangular(lp[:w].T, bk, upper=True,
                                           left=False)
        b0, b1 = x.cols(s, s + w)
        X[:, b0:b1] = xk[:, x.col0 + b0 - s:x.col0 + b1 - s]
        b0, b1 = x.cols(s + w, n)
        if b1 > b0:
            X[:, b0:b1].addmm_(xk, lp[x.col0 + b0 - s:x.col0 + b1 - s].T,
                               alpha=-1.0)
    return x


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
