"""Mixed-precision eigenpair refinement (Ogita-Aishima Newton iteration).

Counterpart of ``eigenkernel_tpu/ops/refine.py`` (``refine_eigenpairs``
and ``_adjacent_jacobi``).  ``dtype='mixed'`` runs the pipeline in
float32 and refines its eigenpairs here against float64 copies of the
caller's matrices.  Per step, with V the approximate eigenvector block:

    R = V^T B V,  S = V^T A V,  lambda_j = S_jj / R_jj,  F = I - R
    E_ij = (S_ij + F_ij lambda_j) / (lambda_j - lambda_i)   (i != j)
    E_ii = F_ii / 2,   V <- V (I + E)

(Newton's method on V^T B V = I, offdiag(V^T A V) = 0).  Pairs whose gap
is below an adaptive, monotone threshold count as one eigenspace and
get only the symmetric F/2 part; a few batched adjacent-pair Jacobi
passes on V^T A V then diagonalize those clusters.

Only the native float64 GEMM branch is ported: the card multiplies in
float64 natively, so the Ozaki slice products (``EK_REFINE_GEMM``,
``EK_REFINE_OZAKI_SCHED[_BIG]``) and the column-blocked large-n variants
(``refine_stepwise``, ``EK_REFINE_STEPWISE``, ``EK_REFINE_CHUNK_MIN``,
``EK_REFINE_NC``, ``EK_REFINE_CLEANUP``, ``EK_REFINE_CLUSTER_CAP``),
which exist for the TPU's emulated float64 and its
16 GB of memory, are left out.  ``EK_REFINE_STEPS`` is read as in the
JAX package, with another default: 8, not 6.  The iteration's residual
oscillates while the threshold unfreezes pairs; on the H100 at n = 4096
(an ELSES-style matrix, the float32 ``scalapack`` start) six steps left
6.5e-10 and eight 4.3e-13 (``chip_smoke.py`` phase 12 prints the
residual by step count).
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch


def refine_eigenpairs(a: torch.Tensor, v: torch.Tensor,
                      b: Optional[torch.Tensor] = None,
                      steps: Optional[int] = None,
                      gap_factor: float = 30.0):
    """Refine approximate eigenvectors ``v`` (columns) of ``A [x = lam B x]``
    in the dtype of ``a`` (pass float64 matrices to refine float32
    results); ``v`` is promoted.

    ``steps=None`` reads ``EK_REFINE_STEPS`` (default 8); ``steps=0`` runs
    only the cluster cleanup.  Returns (values ascending, vectors
    [B-]orthonormal to working precision).
    """
    if steps is None:
        steps = int(os.environ.get("EK_REFINE_STEPS", "8"))
    dtype = a.dtype
    v = v.to(dtype)
    if b is not None:
        b = b.to(dtype)
    k = v.shape[1]
    eye = torch.eye(k, dtype=dtype, device=a.device)
    finfo = torch.finfo(dtype)
    floor = 100.0 * math.sqrt(finfo.eps)
    tiny_prev = None
    for _ in range(steps):
        s = v.T @ (a @ v)
        r = v.T @ (b @ v if b is not None else v)
        lam = s.diagonal() / r.diagonal()
        f = eye - r
        dl = lam[None, :] - lam[:, None]          # lambda_j - lambda_i
        scale = torch.clamp(lam.max() - lam.min(), min=finfo.tiny)
        # pairs with a gap below ~the current error (the orthonormality
        # defect, contraction-aware as sqrt) count as one eigenspace; the
        # threshold never grows, which breaks the period-2 limit cycle of
        # re-frozen marginal pairs (the JAX function's notes)
        err_est = f.abs().max()
        tiny = scale * torch.clamp(torch.sqrt(gap_factor * err_est),
                                   min=floor)
        if tiny_prev is not None:
            tiny = torch.minimum(tiny, tiny_prev)
        tiny_prev = tiny
        safe = dl.abs() > tiny
        e_off = torch.where(safe, (s + f * lam[None, :])
                            / torch.where(safe, dl, 1.0), f * 0.5)
        e = torch.where(eye == 1, f * 0.5, e_off)
        v = v + v @ e
    # cluster cleanup: the members of a near-degenerate cluster are
    # adjacent in the sorted spectrum, so adjacent-pair Jacobi passes on
    # S = V^T A V diagonalize every cluster, then one V @ J product
    s, j_rot = _adjacent_jacobi(v.T @ (a @ v), passes=6)
    v = v @ j_rot
    lam = s.diagonal()
    if b is not None:
        lam = lam / (v * (b @ v)).sum(dim=0)
    order = torch.argsort(lam, stable=True)
    return lam[order], v[:, order]


def _rot_rows(m: torch.Tensor, lo: int, c: torch.Tensor,
              sn: torch.Tensor) -> torch.Tensor:
    """Rotate the row pairs (lo, lo + 1), (lo + 2, lo + 3), ... of ``m`` by
    (c, s): row_j <- c row_j - s row_j+1, row_j+1 <- s row_j + c row_j+1."""
    npair = c.shape[0]
    pair = m[lo:lo + 2 * npair].reshape(npair, 2, -1)
    m0, m1 = pair[:, 0], pair[:, 1]
    c, sn = c[:, None], sn[:, None]
    out = m.clone()
    out[lo:lo + 2 * npair] = torch.stack(
        [c * m0 - sn * m1, sn * m0 + c * m1], dim=1).reshape(2 * npair, -1)
    return out


def _adjacent_jacobi(s: torch.Tensor, passes: int = 6):
    """Alternating odd/even batched Jacobi rotations on adjacent index
    pairs of symmetric ``s``; returns (rotated s, accumulated rotation J)
    with ``s_new = J^T s J``.  Angles are ~0 outside clusters (the
    off-diagonals there are already ~eps), so this is a targeted cluster
    diagonalizer."""
    k = s.shape[0]
    dtype = s.dtype
    j_acc = torch.eye(k, dtype=dtype, device=s.device)
    if k < 2:
        return s, j_acc
    tiny = torch.finfo(dtype).tiny
    for i in range(passes):
        parity = i % 2
        npair = (k - parity) // 2
        if npair == 0:
            # k == 2, parity 1: no adjacent pair starts at index 1
            continue
        p = torch.arange(parity, parity + 2 * npair, 2, device=s.device)
        app, aqq, apq = s[p, p], s[p + 1, p + 1], s[p, p + 1]
        safe = apq.abs() > tiny
        tau = (aqq - app) / torch.where(safe, 2.0 * apq, 1.0)
        tau = torch.clamp(tau, -1e18, 1e18)
        sign = torch.where(tau >= 0, 1.0, -1.0).to(dtype)
        t = torch.where(safe, sign / (tau.abs() + torch.sqrt(1.0 + tau * tau)),
                        0.0)
        c = 1.0 / torch.sqrt(1.0 + t * t)
        sn = t * c
        s = _rot_rows(_rot_rows(s, parity, c, sn).T, parity, c, sn).T
        j_acc = _rot_rows(j_acc.T, parity, c, sn).T
    return s, j_acc
