"""Symmetric tridiagonal eigensolver: divide and conquer for the full
spectrum, bisection + inverse iteration for a part of it.

Counterpart of ``eigenkernel_tpu/ops/tridiag.py``.  Divide and conquer
(:mod:`.dc`, the pdstedc analog) takes half the spectrum or more; the
selecting core (the pdsyevx analog) runs

* eigenvalues by Sturm-count bisection (:mod:`.sturm`, the CUDA kernel
  on a CUDA tensor, its plain version on a CPU tensor),
* shifts closer than ``4 eps span`` spread apart so inverse iteration
  targets distinct points inside degenerate clusters,
* ``INVIT_STEPS`` rounds of batched shifted solves (:mod:`.tridiag_solve`)
  from a seeded random start block, normalizing each column; pivots are
  floored at ``eps max|T|`` as in LAPACK's dstein (the JAX package's
  absolute 1e-30 floor fails on glued Wilkinson matrices, see
  :func:`pivot_floor`),
* CholeskyQR2 to orthonormalize the block (mixes vectors only within
  clusters, since the Gram matrix is near identity elsewhere).

On a process grid (``mesh=``, d and e the same on every rank) the result
is a :class:`~eigenkernel_tpu_torch.parallel.mesh.ColumnShares`.  Divide
and conquer shards its top merges (:mod:`.dc`).  The selecting core gives
each rank a contiguous share of the k targets: bisection (B1) and the
shifted solves (B2) run on the rank's own lanes, the eigenvalues are
gathered for the shift separation, and the random start is made whole on
every rank and sliced, so each lane computes what it computes on one
device, bit for bit, up to the first column normalization.  CholeskyQR2
forms the k x k Gram from the ranks' row blocks by one ``all_reduce`` and
factors it on every rank; the column shares become row blocks and back by
each rank's broadcast in turn, so no rank holds the whole n x k block
beyond the random start, made whole and sliced.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from eigenkernel_tpu_torch.obs import events
from eigenkernel_tpu_torch.ops import dc, sturm, tridiag_solve
from eigenkernel_tpu_torch.ops.blocked import blocked_cholesky
from eigenkernel_tpu_torch.ops.householder import tridiag_matrix
from eigenkernel_tpu_torch.parallel import mesh as pm

INVIT_SEED = 7
INVIT_STEPS = 3


def gershgorin_bounds(d: torch.Tensor, e: torch.Tensor):
    """(lo, hi) 0-d tensors enclosing the spectrum, widened by 0.1 %."""
    n, dtype = d.shape[0], d.dtype
    r = torch.zeros_like(d)
    if n > 1:
        eab = e.abs()
        r[:-1] += eab
        r[1:] += eab
    lo = (d - r).min()
    hi = (d + r).max()
    span = torch.clamp(hi - lo, min=torch.finfo(dtype).tiny)
    return lo - 0.001 * span, hi + 0.001 * span


def bisect_eigenvalues(d: torch.Tensor, e: torch.Tensor,
                       indices: torch.Tensor,
                       iters: Optional[int] = None) -> torch.Tensor:
    """Eigenvalues ``lambda_indices`` (0-based, ascending) by bisection:
    62 steps in float64, 30 in float32, on the Gershgorin interval."""
    if iters is None:
        iters = 62 if d.dtype == torch.float64 else 30
    lo, hi = gershgorin_bounds(d, e)
    return sturm.sturm_bisect(d, e, indices.to(torch.int32), lo, hi, iters)


def separate_shifts(lam: torch.Tensor, minsep) -> torch.Tensor:
    """Spread sorted shifts so consecutive ones differ by >= minsep:
    ``s_j = j minsep + cummax(lam_j - j minsep)`` (dstein's perturbation)."""
    j = torch.arange(lam.shape[0], dtype=lam.dtype, device=lam.device)
    t = torch.cummax(lam - j * minsep, dim=0).values
    return t + j * minsep


def cholqr2(v: torch.Tensor, mesh: Optional[pm.ProcessGrid] = None,
            cols: Optional[tuple[int, int]] = None,
            k: Optional[int] = None) -> torch.Tensor:
    """Orthonormalize the columns of ``v`` by two rounds of Cholesky-QR.

    With ``mesh``, ``v`` is this rank's columns ``cols`` = (lo, hi), its
    :func:`~eigenkernel_tpu_torch.parallel.mesh.share` of the k, of an
    (n, k) block.  Each rank takes a share of the rows from every rank's
    columns (broadcast in turn), the Gram is the ``all_reduce`` of the row
    blocks' products, and each rank takes its columns back from every
    rank's rows the same way; no rank holds the whole block."""
    if mesh is None:
        return _cholqr2_rows(v)
    P, n = mesh.size, v.shape[0]
    lo, hi = cols
    col_shares = [pm.share(k, P, q) for q in range(P)]
    row_shares = [pm.share(n, P, q) for q in range(P)]
    r0, r1 = row_shares[mesh.rank]
    rows = v.new_empty((r1 - r0, k))
    for q, part in pm.rank_shares(v, mesh, [(n, b - a)
                                            for a, b in col_shares]):
        a, b = col_shares[q]
        rows[:, a:b] = part[r0:r1]
    rows = _cholqr2_rows(rows, mesh)
    out = v.new_empty((n, hi - lo))
    for q, part in pm.rank_shares(rows, mesh, [(b - a, k)
                                               for a, b in row_shares]):
        a, b = row_shares[q]
        out[a:b] = part[:, lo:hi]
    return out


def _cholqr2_rows(v: torch.Tensor,
                  mesh: Optional[pm.ProcessGrid] = None) -> torch.Tensor:
    """Two rounds of Cholesky-QR on ``v``, or on the rows of a block that
    ``v`` holds of it on this rank (the Gram summed over ``mesh``)."""
    for _ in range(2):
        g = v.T @ v
        if mesh is not None:
            pm.all_reduce(g, mesh)
        l = blocked_cholesky(g)
        # v <- v L^{-T}
        v = torch.linalg.solve_triangular(l.T, v, upper=True, left=False)
    return v


def pivot_floor(d: torch.Tensor, e: torch.Tensor) -> float:
    """Inverse iteration's pivot floor, ``eps max(|d|, |e|)``: a shift
    that zeroes a leading minor exactly is then a perturbation of T at
    rounding level.  With the absolute floor of the JAX package's Pallas
    kernel (1e-30) the multiplier after such a pivot is 1e30, and its
    rounding leaves residuals of 1e-3 on glued Wilkinson matrices.  A zero
    T is floored as if its scale were 1."""
    with events.span("wait:pivot_floor"):
        scale = float(torch.cat([d.abs(), e.abs()]).max())
    return torch.finfo(d.dtype).eps * (scale if scale > 0 else 1.0)


def tridiag_eigh(d: torch.Tensor, e: torch.Tensor,
                 n_vec: Optional[int] = None,
                 mesh: Optional[pm.ProcessGrid] = None):
    """Eigen-decomposition of a symmetric tridiagonal matrix.

    Returns (values, vectors): values ascending, vectors (n, n_vec); with
    ``mesh`` a :class:`~eigenkernel_tpu_torch.parallel.mesh.ColumnShares`
    of the n_vec pairs.  ``n_vec`` selects the lowest part of the
    spectrum.  ``EK_TRIDIAG`` = auto | bisect | dc picks the core; auto
    takes divide and conquer for half the spectrum or more.
    """
    n, dtype, dev = d.shape[0], d.dtype, d.device
    k = n if n_vec is None else int(n_vec)
    if n <= 8:
        w, z = torch.linalg.eigh(tridiag_matrix(d, e))
        if mesh is not None:
            return pm.contiguous_shares(w[:k], z[:, :k], mesh)
        return w[:k], z[:, :k]

    core = os.environ.get("EK_TRIDIAG", "auto")
    if core == "auto":
        core = "dc" if 2 * k >= n else "bisect"
    if core == "dc":
        if mesh is not None:
            w, z, cols = dc.tridiag_dc(d, e, mesh=mesh)
            keep = cols < k
            return pm.ColumnShares(w[:k], z[:, keep], cols[keep])
        w, z = dc.tridiag_dc(d, e)
        return w[:k], z[:, :k]

    # on a grid, this rank's lanes j0..j1-1 of the k
    j0, j1 = (0, k) if mesh is None else pm.share(k, mesh.size, mesh.rank)
    lam = bisect_eigenvalues(
        d, e, torch.arange(j0, j1, dtype=torch.int32, device=dev)) \
        if j1 > j0 else d.new_zeros(0)
    if mesh is not None:
        lam = pm.gather_slots(lam, slice(j0, j1), (k,), mesh)

    eps = torch.finfo(dtype).eps
    lo, hi = gershgorin_bounds(d, e)
    lam_sep = separate_shifts(lam, 4.0 * eps * (hi - lo))[j0:j1]

    tiny = pivot_floor(d, e)
    gen = torch.Generator(device=dev).manual_seed(INVIT_SEED)
    v = torch.randn((n, k), generator=gen, dtype=dtype, device=dev)
    if mesh is not None:
        v = v[:, j0:j1].contiguous()
    if j1 > j0:
        for _ in range(INVIT_STEPS):
            v = tridiag_solve.tridiag_solve(d, e, lam_sep, v, tiny)
            v = v / torch.linalg.vector_norm(v, dim=0, keepdim=True)
    if mesh is None:
        return lam, cholqr2(v)
    return pm.ColumnShares(lam, cholqr2(v, mesh, (j0, j1), k),
                           torch.arange(j0, j1, device=dev))
