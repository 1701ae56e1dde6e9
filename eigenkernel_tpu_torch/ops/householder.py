"""Blocked Householder tridiagonalization + compact-WY back-transform.

Counterpart of ``eigenkernel_tpu/ops/householder.py``:

* ``tridiagonalize`` <- ``pdsytrd``: ``T = Q^T A Q`` with
  ``Q = H_0 H_1 ... H_{n-2}``, lower variant.
* ``apply_q``        <- ``pdormtr``: ``z <- Q z``.

``tridiagonalize`` is the plain LAPACK dsytrd/dlatrd: each panel of ``b``
columns runs its Householder steps with the panel's pending updates kept
as ``V`` and ``W = tau (A v - corrections)`` columns, then the trailing
block, which shrinks panel by panel, takes one rank-2b update
``A22 -= [V W] [W V]^T``.  The last panel may be narrower than ``b``.
(The JAX package's masked full-size panels and bucketed recursion exist
because every XLA shape compiles separately; eager PyTorch has no such
cost.)

``apply_q`` applies groups of panels in reverse with the compact-WY
identity ``H_s ... H_{s+g-1} = I - V T V^T``,
``T = inv(diag(1/tau) + striu(V^T V))``, so the back-transform is GEMMs plus
one small triangular solve per group.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TridiagResult(NamedTuple):
    d: torch.Tensor     # (n,)   diagonal of T
    e: torch.Tensor     # (n-1,) subdiagonal of T
    V: torch.Tensor     # (n, n) Householder vectors, column c = v_c (v[c+1]=1)
    taus: torch.Tensor  # (n,)   reflector coefficients (0 => identity)


def _householder(x: torch.Tensor, alpha: torch.Tensor):
    """Reflector ``(I - tau v v^T) [alpha; x] = [beta; 0]`` with
    ``v = [head; tail]``.

    ``head`` is 1, or 0 when ``x`` is zero (then tau = 0 and beta = alpha:
    the identity).  ``beta = -sign(alpha) ||[alpha; x]||`` with
    sign(0) = +1, the JAX package's convention.  All on the device: no
    host synchronization.
    """
    sigma = (x * x).sum()
    zero_tail = sigma == 0
    sgn = torch.where(alpha >= 0, 1.0, -1.0).to(alpha.dtype)
    mu = torch.sqrt(alpha * alpha + sigma)
    beta = torch.where(zero_tail, alpha, -sgn * mu)
    denom = torch.where(zero_tail, 1.0, alpha - beta)
    tail = x / denom
    tau = torch.where(zero_tail, 0.0,
                      (beta - alpha) / torch.where(beta == 0, 1.0, beta))
    head = torch.logical_not(zero_tail).to(alpha.dtype)
    return head, tail, tau, beta


def tridiagonalize(a: torch.Tensor, block: int = 64) -> TridiagResult:
    """Reduce symmetric ``a`` to tridiagonal ``T = Q^T A Q`` (pdsytrd
    analog).  ``a`` is not modified."""
    n = a.shape[0]
    dtype, dev = a.dtype, a.device
    b = max(1, min(block, n))
    A = a.clone()
    d = torch.zeros(n, dtype=dtype, device=dev)
    e = torch.zeros(max(n - 1, 0), dtype=dtype, device=dev)
    taus = torch.zeros(n, dtype=dtype, device=dev)
    V = torch.zeros((n, n), dtype=dtype, device=dev)
    for s in range(0, n, b):
        bw = min(b, n - s)
        As = A[s:, s:]                     # trailing block, a view of A
        m = n - s
        Vp = torch.zeros((m, bw), dtype=dtype, device=dev)
        Wp = torch.zeros((m, bw), dtype=dtype, device=dev)
        for j in range(bw):
            c = s + j
            # column j with the panel's pending updates, rows j..m-1
            col = As[j:, j] - Vp[j:, :j] @ Wp[j, :j] - Wp[j:, :j] @ Vp[j, :j]
            d[c] = col[0]
            if c == n - 1:
                break
            head, tail, tau, beta = _householder(col[2:], col[1])
            e[c] = beta
            taus[c] = tau
            r = j + 1                      # pivot row; v vanishes above it
            v = torch.cat([head.reshape(1), tail])
            Vr, Wr = Vp[r:, :j], Wp[r:, :j]
            # w = tau (A v - V (W^T v) - W (V^T v)) - (tau/2)(w^T v) v
            av = As[r:, r:] @ v - Vr @ (Wr.T @ v) - Wr @ (Vr.T @ v)
            w = tau * av
            w = w - (0.5 * tau * (w @ v)) * v
            Vp[r:, j] = v
            Wp[r:, j] = w
        if bw < m:
            vw = torch.cat([Vp[bw:], Wp[bw:]], dim=1)
            wv = torch.cat([Wp[bw:], Vp[bw:]], dim=1)
            As[bw:, bw:].addmm_(vw, wv.T, alpha=-1.0)
        V[s:, s:s + bw] = Vp
    return TridiagResult(d=d, e=e, V=V, taus=taus)


def wy_t_factor(v: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """Compact-WY T factor: ``H_1...H_b = I - V T V^T`` with T upper
    triangular, via ``T = inv(diag(1/tau) + striu(V^T V))``.

    taus of exactly 0 denote identity reflectors (their V column is zero);
    the safe diagonal keeps the small inverse well defined.
    """
    b = taus.shape[0]
    g = v.T @ v
    safe_diag = 1.0 / torch.where(taus == 0, 1.0, taus)
    m = torch.triu(g, diagonal=1) + torch.diag(safe_diag)
    eye = torch.eye(b, dtype=v.dtype, device=v.device)
    return torch.linalg.solve_triangular(m, eye, upper=True)


def apply_wy(V: torch.Tensor, taus: torch.Tensor, z: torch.Tensor,
             block: int = 64) -> torch.Tensor:
    """``H_0 H_1 ... z`` for reflectors stored as the columns of ``V``
    (column c zero above row c), each group of panels as one compact-WY
    product.

    Groups of panels of up to 512 columns are applied last to first, each
    as ``z -= V (T (V^T z))`` on the rows the group's reflectors touch:
    one pass over z per group instead of one per panel.  Returns a new
    tensor; ``z`` is not modified.
    """
    n = V.shape[0]
    b = max(1, min(block, n))
    gb = max(1, 512 // b) * b
    z = z.clone()
    for s in reversed(range(0, n, gb)):
        w = min(gb, n - s)
        v = V[s:, s:s + w]                 # rows above s are zero
        t = wy_t_factor(v, taus[s:s + w])
        zs = z[s:]
        zs -= v @ (t @ (v.T @ zs))
    return z


def apply_q(tri: TridiagResult, z: torch.Tensor,
            block: int = 64) -> torch.Tensor:
    """``Q z`` with Q from :func:`tridiagonalize` (pdormtr analog)."""
    return apply_wy(tri.V, tri.taus, z, block)


def tridiag_matrix(d: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Dense tridiagonal matrix from (d, e) — for tests and small n."""
    t = torch.diag(d)
    if d.shape[0] > 1:
        t = t + torch.diag(e, 1) + torch.diag(e, -1)
    return t
