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
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from eigenkernel_tpu_torch.ops import dc, sturm, tridiag_solve
from eigenkernel_tpu_torch.ops.blocked import blocked_cholesky
from eigenkernel_tpu_torch.ops.householder import tridiag_matrix

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


def cholqr2(v: torch.Tensor) -> torch.Tensor:
    """Orthonormalize the columns of ``v`` by two rounds of Cholesky-QR."""
    for _ in range(2):
        l = blocked_cholesky(v.T @ v)
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
    scale = float(torch.cat([d.abs(), e.abs()]).max())
    return torch.finfo(d.dtype).eps * (scale if scale > 0 else 1.0)


def tridiag_eigh(d: torch.Tensor, e: torch.Tensor,
                 n_vec: Optional[int] = None):
    """Eigen-decomposition of a symmetric tridiagonal matrix.

    Returns (values, vectors): values ascending, vectors (n, n_vec).
    ``n_vec`` selects the lowest part of the spectrum.  ``EK_TRIDIAG`` =
    auto | bisect | dc picks the core; auto takes divide and conquer for
    half the spectrum or more.
    """
    n, dtype, dev = d.shape[0], d.dtype, d.device
    k = n if n_vec is None else int(n_vec)
    if n <= 8:
        w, z = torch.linalg.eigh(tridiag_matrix(d, e))
        return w[:k], z[:, :k]

    core = os.environ.get("EK_TRIDIAG", "auto")
    if core == "auto":
        core = "dc" if 2 * k >= n else "bisect"
    if core == "dc":
        w, z = dc.tridiag_dc(d, e)
        return w[:k], z[:, :k]

    lam = bisect_eigenvalues(
        d, e, torch.arange(k, dtype=torch.int32, device=dev))

    eps = torch.finfo(dtype).eps
    lo, hi = gershgorin_bounds(d, e)
    lam_sep = separate_shifts(lam, 4.0 * eps * (hi - lo))

    tiny = pivot_floor(d, e)
    gen = torch.Generator(device=dev).manual_seed(INVIT_SEED)
    v = torch.randn((n, k), generator=gen, dtype=dtype, device=dev)
    for _ in range(INVIT_STEPS):
        v = tridiag_solve.tridiag_solve(d, e, lam_sep, v, tiny)
        v = v / torch.linalg.vector_norm(v, dim=0, keepdim=True)
    return lam, cholqr2(v)
