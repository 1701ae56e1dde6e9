"""Two-stage reduction, stage 1: full -> symmetric band matrix.

Counterpart of ``eigenkernel_tpu/ops/band.py`` (the first stage of ELPA2's
and EigenExa eigen_sx's two-stage solvers): ``A_band = Q^T A Q`` with
semibandwidth ``bw``, all O(n^3) work in GEMMs.

Panel s (columns ``s .. s+bw-1``) QR-factors the block below the band,
``A[s+bw:, s:s+bw]``, with Householder reflectors whose unit pivots sit at
rows ``s+bw+j``; one symmetric WY update of the trailing block

    u = (A V) T - V (T^T (V^T A V) T) / 2,      A <- A - u V^T - V u^T

applies the two-sided transform ``diag(I, Q_s)^T A diag(I, Q_s)``.  The
loop runs over a trailing block that shrinks panel by panel, and the last
panel may have fewer than ``bw`` rows below the band, so any n works.  (The
JAX package's bucketed recursion ``_to_band_rec``, ``EK_TOBAND_SPLIT`` and
``EK_QR_PANEL`` exist for XLA shapes and a TPU A/B; eager PyTorch needs
none of them.)  The GEMMs are ``torch.matmul`` (cuBLAS on the card), as the
JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from eigenkernel_tpu_torch.ops.householder import (_householder, apply_wy,
                                                   wy_t_factor)


class BandResult(NamedTuple):
    band: Optional[torch.Tensor]  # (n, n) band matrix; None once the chase
                                  # has read it
    V: torch.Tensor     # (n, n) reflectors; column s+j pivots at row s+bw+j
    taus: torch.Tensor  # (n,)   reflector coefficients (0 => identity)
    bw: int


def _qr_panel(p: torch.Tensor):
    """Householder QR of the (m, b) block ``p``: column j's reflector has
    its unit pivot at row j and zeros above.  Returns ``(V, taus)``, V
    (m, b); ``p`` is overwritten (its R factor is not needed: the WY update
    regenerates it)."""
    m, b = p.shape
    V = torch.zeros((m, b), dtype=p.dtype, device=p.device)
    taus = torch.zeros(b, dtype=p.dtype, device=p.device)
    for j in range(min(b, m)):
        head, tail, tau, _ = _householder(p[j + 1:, j], p[j, j])
        V[j, j] = head
        V[j + 1:, j] = tail
        taus[j] = tau
        if j + 1 < b:
            v = V[j:, j]
            rest = p[j:, j + 1:]
            rest -= tau * torch.outer(v, v @ rest)
    return V, taus


def to_band(a: torch.Tensor, bw: int) -> BandResult:
    """Reduce symmetric ``a`` to a band matrix ``Q^T A Q`` of semibandwidth
    ``bw``.  ``a`` is not modified."""
    n = a.shape[0]
    dtype, dev = a.dtype, a.device
    if bw < 1:
        raise ValueError(f"to_band: bandwidth must be >= 1, got {bw}")
    A = a.clone()
    V = torch.zeros((n, n), dtype=dtype, device=dev)
    taus = torch.zeros(n, dtype=dtype, device=dev)
    for s in range(0, max(n - bw, 0), bw):
        As = A[s:, s:]                     # trailing block, a view of A
        V2, tp = _qr_panel(As[bw:, :bw].clone())
        t = wy_t_factor(V2, tp)
        av = As[:, bw:] @ V2               # A V, V = [0; V2]
        u = av @ t
        u[bw:] -= 0.5 * (V2 @ (t.T @ (V2.T @ av[bw:]) @ t))
        u1, u2 = u[:bw], u[bw:]
        # one concatenated rank-2b GEMM on the trailing block, as the JAX
        # package does: u2 V2^T + V2 u2^T = [u2 V2] [V2 u2]^T
        uv = torch.cat([u2, V2], dim=1)
        vu = torch.cat([V2, u2], dim=1)
        As[bw:, bw:].addmm_(uv, vu.T, alpha=-1.0)
        As[bw:, :bw] -= V2 @ u1.T
        As[:bw, bw:] -= u1 @ V2.T
        V[s + bw:, s:s + bw] = V2
        taus[s:s + bw] = tp
    # clear the eliminated entries' roundoff outside the band, symmetrize
    A.tril_(bw).triu_(-bw)
    band = A + A.T
    del A
    band *= 0.5
    return BandResult(band=band, V=V, taus=taus, bw=bw)


def apply_band_q(res: BandResult, z: torch.Tensor,
                 block: int = 64) -> torch.Tensor:
    """``z <- Q z`` with Q the stage-1 band-reduction transform: groups of
    panels as compact-WY products, last to first (see
    :func:`eigenkernel_tpu_torch.ops.householder.apply_wy`).  Returns a new
    tensor."""
    return apply_wy(res.V, res.taus, z, block)
