"""The plain reference that decides ``correct``.

Plain PyTorch in float64 with TF32 off; it imports nothing of the port
and works again from the matrices the benchmark made from the seed.

* :func:`eigenvalues`: every eigenvalue of ``A x = lambda x``, or of the
  pencil ``A x = lambda B x`` through its Cholesky form
  ``C = L^-1 A L^-T`` (``B = L L^T``), ascending, by
  ``torch.linalg.eigvalsh``.
* :func:`judge`: the numbers that hold a solve's eigenpairs to it:

  - ``eig_err``: max_i |lambda_i - lambda_ref_i| / max |lambda_ref|, over
    the lowest ``n_vec`` values of every solve;
  - ``residual``: max_j ||A v_j - lambda_j B v_j|| /
    ((||A||_1 + |lambda_j| ||B||_1) ||v_j||), the 1-norms bounding the
    2-norms of the symmetric matrices (``B = I`` for a standard
    problem);
  - ``orth``: max_ij |V^T B V - I|_ij.

  The last solve of the window is judged whole (every column; its Gram
  matrix in blocks of columns), the others on a sample of columns drawn
  from the seed.  A number that is not finite, or a result of the wrong
  shape, reads :data:`WRONG`.
"""

from __future__ import annotations

import math
import sys

import torch

BLOCK = 1024   # columns a product while judging
WRONG = sys.float_info.max


def _highest() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def eigenvalues(a: torch.Tensor, b: torch.Tensor | None = None):
    """All eigenvalues ascending, float64."""
    _highest()
    a = a.to(torch.float64)
    if b is None:
        return torch.linalg.eigvalsh(a)
    l = torch.linalg.cholesky(b.to(torch.float64))
    c = torch.linalg.solve_triangular(l, a, upper=False)       # L^-1 A
    c = torch.linalg.solve_triangular(l, c.T, upper=False)     # L^-1 A L^-T
    del l
    c = c + c.T
    c *= 0.5
    return torch.linalg.eigvalsh(c)


def norm1(m: torch.Tensor) -> float:
    return float(m.abs().sum(dim=0).max())


def _bmul(b: torch.Tensor | None, v: torch.Tensor) -> torch.Tensor:
    return v if b is None else b @ v


def _pairs(a, b, w, v, na, nb):
    """(largest relative residual, B v) of the columns ``v``."""
    bv = _bmul(b, v)
    r = a @ v - bv * w
    scale = (na + w.abs() * nb) * v.norm(dim=0)
    return float((r.norm(dim=0) / scale).max()), bv


def judge(a: torch.Tensor, b: torch.Tensor | None, ref: torch.Tensor,
          k: int, values: list, samples: list, idx: torch.Tensor,
          last_values: torch.Tensor, last_vectors: torch.Tensor) -> dict:
    """Every compared number, and each solve's: {"eig_err", "residual",
    "orth", "per_solve": [(eig_err, residual, orth), ...]}, of solves
    that were to return the lowest ``k`` pairs.  ``values`` holds every
    judged solve's values (the last one's included), ``samples`` the
    sampled columns ``idx`` of every solve but the last."""
    _highest()
    dev = a.device
    a = a.to(torch.float64)
    b = None if b is None else b.to(torch.float64)
    na, nb = norm1(a), (1.0 if b is None else norm1(b))
    ref = ref.to(dev, torch.float64)
    scale = float(ref.abs().max())
    n = a.shape[0]
    per = []
    if last_vectors.shape != (n, k) or any(
            s.shape != (n, idx.numel()) for s in samples):
        return {"eig_err": WRONG, "residual": WRONG, "orth": WRONG,
                "per_solve": [(WRONG,) * 3] * len(values)}

    def eig_err(w):
        w = w.to(dev, torch.float64)
        if w.shape != (k,):
            return WRONG
        return float((w - ref[:k]).abs().max()) / scale

    def clean(x):
        return x if math.isfinite(x) else WRONG

    for w, vs in zip(values[:-1], samples):
        w = w.to(dev, torch.float64)
        vs = vs.to(dev, torch.float64)
        res, bv = _pairs(a, b, w[idx], vs, na, nb)
        g = vs.T @ bv
        g.diagonal().sub_(1.0)
        orth = clean(float(g.abs().max()))
        per.append((clean(eig_err(w)), clean(res), orth))
    # the last solve, every column: residuals and the Gram matrix by blocks
    v = last_vectors.to(dev, torch.float64)
    w = last_values.to(dev, torch.float64)
    res = orth = 0.0
    for s in range(0, k, BLOCK):
        sl = slice(s, min(s + BLOCK, k))
        r, bv = _pairs(a, b, w[sl], v[:, sl], na, nb)
        g = v.T @ bv
        g[sl].diagonal().sub_(1.0)
        res = max(res, clean(r))
        orth = max(orth, clean(float(g.abs().max())))
        del bv, g
    per.append((clean(eig_err(values[-1])), res, orth))
    return {"eig_err": max(p[0] for p in per),
            "residual": max(p[1] for p in per),
            "orth": max(p[2] for p in per),
            "per_solve": per}
