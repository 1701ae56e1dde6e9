"""QDWH matrix-sign iteration and spectral divide-and-conquer eigensolver
(the ``qdwh`` core).

Counterpart of ``eigenkernel_tpu/ops/qdwh.py``: the Nakatsukasa-Higham
QDWH-eig scheme.  ``U = sign(A - sigma I)`` by the dynamically weighted
Halley iteration (:func:`sign_qdwh`), the projector ``P = (I - U) / 2`` onto
the below-sigma invariant subspace, an orthonormal basis of range(P) and
its complement, and a recursion on the two diagonal blocks of the rotated
matrix.  Every step is a matrix product, a Cholesky factorization, a
triangular solve or a tall QR (cuBLAS and cuSOLVER on the card).

The recursion runs on the host on exact sizes: a child block is
``d[:k, :k]`` or ``d[k:, k:]``, with no sentinel padding, so the JAX
function's bucketed static-shape jits (``_bucket``, ``_j_slice_pad``, the
masked ``_j_assemble``) are left out.  The probe G of an m x m block is
the JAX function's own, numpy ``default_rng(seed + m).standard_normal((m,
m))``, so both packages split an unpadded top block on the same G.  The
JAX function's ``block`` argument (the Cholesky and triangular-solve block
of its recursive kernels) has no counterpart: ``ops/blocked.py`` calls
``torch.linalg`` on the whole matrix.  Matrix products run with TF32 off.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from eigenkernel_tpu_torch.core.config import set_matmul_precision_highest
from eigenkernel_tpu_torch.ops.blocked import (NotPositiveDefiniteError,
                                               blocked_cholesky, symmetrize,
                                               trsm_lower)
from eigenkernel_tpu_torch.ops.tridiag import cholqr2

# sigma candidates: quantiles of the block's diagonal, tried in order
_SIGMA_QUANTILES = (0.5, 0.35, 0.65, 0.2, 0.8)


def qdwh_weights(l0: float, max_iter: int = 40):
    """Dynamically weighted Halley coefficient schedule.

    Returns the list of (a, b, c) per iteration, computed on the host from
    the lower bound ``l0 <= sigma_min(X0)``.  Terminates when l has
    converged to 1, plus one plain Halley polish step (a,b,c)=(3,1,3).
    """
    l = float(min(max(l0, 1e-18), 1.0))
    out = []
    for _ in range(max_iter):
        d = (4.0 * (1.0 - l * l) / (l ** 4)) ** (1.0 / 3.0)
        a = math.sqrt(1.0 + d) + 0.5 * math.sqrt(
            8.0 - 4.0 * d + 8.0 * (2.0 - l * l) / (l * l * math.sqrt(1.0 + d)))
        b = (a - 1.0) ** 2 / 4.0
        c = a + b - 1.0
        out.append((a, b, c))
        l = l * (a + b * l * l) / (1.0 + c * l * l)
        if 1.0 - l < 1e-14:
            break
    out.append((3.0, 1.0, 3.0))  # Halley polish
    return out


def sign_qdwh(x: torch.Tensor, l0: Optional[float] = None,
              qr_switch: float = 100.0) -> torch.Tensor:
    """Matrix sign function of a symmetric ``x`` by the QDWH iteration.

    Early ill-conditioned iterations (c > qr_switch) use the
    backward-stable QR form on the stacked (2m, m) matrix; the rest the
    cheaper Cholesky form.  Every iterate is symmetrized.
    """
    set_matmul_precision_highest()
    m = x.shape[0]
    dt = x.dtype
    if l0 is None:
        l0 = 1e-16 if dt == torch.float64 else 1e-7
    eye = torch.eye(m, dtype=dt, device=x.device)
    alpha = torch.clamp(torch.linalg.matrix_norm(x), min=1e-30)
    x = x / alpha
    for a, b, c in qdwh_weights(l0):
        if c > qr_switch:
            sc = math.sqrt(c)
            q, _ = torch.linalg.qr(torch.cat([sc * x, eye], dim=0))
            x = (b / c) * x + ((a - b / c) / sc) * (q[:m] @ q[m:].T)
        else:
            l = blocked_cholesky(eye + c * (x @ x))
            w = trsm_lower(l, x)                             # L^-1 X
            y = trsm_lower(l, w, transpose=True).T           # X Z^-1
            x = (b / c) * x + (a - b / c) * y
        x = symmetrize(x)
    return x


def _split(a: torch.Tensor, sigma: float, g: torch.Tensor, otol: float):
    """One spectral split of ``a`` at ``sigma`` with probe ``g``: (v, d, k)
    with v the orthogonal splitting basis and d = v^T a v block-diagonal
    around k, or None when the host's three checks refuse it: 0 < k < m,
    the basis orthogonal to ``otol`` and the coupling |d[k:, :k]| at most
    ``otol`` times max(||a||_F, 1)."""
    m = a.shape[0]
    eye = torch.eye(m, dtype=a.dtype, device=a.device)
    u = sign_qdwh(a - sigma * eye)
    k = int(torch.round((m - torch.trace(u)) / 2))
    if not 0 < k < m:
        return None
    pg = 0.5 * (g - u @ g)                            # P_minus G
    # any k columns of P G span range(P) (G random), the rest of (I - P) G
    # its complement: CholeskyQR2 of Y gives the basis, no pivoting
    y = torch.cat([pg[:, :k], (g - pg)[:, k:]], dim=1)
    try:
        v = cholqr2(y)
    except NotPositiveDefiniteError:
        return None
    d = symmetrize(v.T @ (a @ v))
    off = float(d[k:, :k].abs().max())
    orth = float((v.T @ v - eye).abs().max())
    anorm = float(torch.linalg.matrix_norm(a))
    if orth < otol and off <= otol * max(anorm, 1.0):
        return v, d, k
    return None


def spectral_dc_eigh(a: torch.Tensor, base: int = 256, seed: int = 7):
    """Full eigendecomposition of symmetric ``a`` by QDWH spectral
    divide-and-conquer.  Returns (w, v), w ascending.

    A block of at most ``base`` rows, or one that no sigma candidate
    splits (a tight cluster spanning every quantile: the block is
    numerically near sigma I), is solved by ``torch.linalg.eigh``, as the
    JAX function's base case.
    """
    dt, dev = a.dtype, a.device
    otol = 5e-5 if dt == torch.float32 else 1e-10

    def probe(mm: int) -> torch.Tensor:
        rng = np.random.default_rng(seed + mm)
        return torch.as_tensor(rng.standard_normal((mm, mm)), dtype=dt,
                               device=dev)

    def rec(blk: torch.Tensor):
        mm = blk.shape[0]
        if mm <= base:
            return torch.linalg.eigh(blk)
        diag = blk.diagonal().cpu().numpy()
        g = probe(mm)
        for q in _SIGMA_QUANTILES:
            split = _split(blk, float(np.quantile(diag, q)), g, otol)
            if split is not None:
                break
        else:
            return torch.linalg.eigh(blk)
        v, d, k = split
        del g
        w1, v1 = rec(d[:k, :k])
        w2, v2 = rec(d[k:, k:])
        del d
        # v @ block_diag(v1, v2)
        return (torch.cat([w1, w2]),
                torch.cat([v[:, :k] @ v1, v[:, k:] @ v2], dim=1))

    return rec(a)
