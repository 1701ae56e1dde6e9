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
"""

from __future__ import annotations

import numpy as np
import torch

from eigenkernel_tpu_torch.core.config import set_matmul_precision_highest
from eigenkernel_tpu_torch.core.types import EigenPairs


def _times_b(b, v: torch.Tensor) -> torch.Tensor:
    """``B v``, or ``v`` without B."""
    if b is None:
        return v
    return torch.as_tensor(b).to(device=v.device, dtype=v.dtype) @ v


def eval_residual_norm(a, eigenpairs: EigenPairs, n_check: int, b=None):
    """Average and max of ``||A v - lambda [B] v||_2 / ||A||_F`` over the
    first ``n_check`` eigenpairs.  Returns (A_norm, ave, max) as floats."""
    set_matmul_precision_highest()
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
    return ipr.double().cpu().numpy()
