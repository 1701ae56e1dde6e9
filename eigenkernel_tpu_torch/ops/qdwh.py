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
from eigenkernel_tpu_torch.ops.blocked import (GEMM_BLOCK,
                                               NotPositiveDefiniteError,
                                               blocked_cholesky,
                                               gershgorin_sentinel,
                                               symmetrize, trsm_lower,
                                               trsm_right_lower_t)
from eigenkernel_tpu_torch.ops.tridiag import cholqr2
from eigenkernel_tpu_torch.parallel import mesh as pm

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


# ---------------------------------------------------------------------------
# on a process grid
# ---------------------------------------------------------------------------
#
# Every step is written on the grid's DistMatrix ops: SUMMA products
# (``pm.matmul``), the panel Cholesky and triangular solves of
# ``ops/blocked.py``, ``symmetrize`` by ``pm.transpose``.  Two steps are
# decided by the words that move (PERF.md §6):
#
# * the QR form of the sign iteration (c > 100: the first two iterations
#   of a split, in float64 and float32) gathers the iterate whole and
#   factors the stacked (2m, m) matrix on every rank, as XLA does for the
#   JAX mesh (m^2 words a rank, a peak of about 6 m^2 words); a
#   Householder QR on the grid's column panels is queued (ROADMAP).
# * a child at most n / sqrt(P) wide (so at most n^2 / P words, a rank's
#   share of the top matrix) is gathered whole onto every rank (one
#   ``all_reduce`` of its words) and solved there by
#   :func:`spectral_dc_eigh`, replicated, each rank keeping its share of
#   the columns, as the grid's ``eigh`` core does; a grid split moves
#   some 40 m^2 words a rank, a gather m^2.  A wider child is cut out of
#   the rotated matrix onto a DistMatrix of its own (``pm.submatrix``,
#   each rank's block broadcast in turn), sentinel on its new padding,
#   and split on the grid again.

def sign_qdwh_grid(x: pm.DistMatrix, l0: Optional[float] = None,
                   qr_switch: float = 100.0,
                   block: int = GEMM_BLOCK) -> pm.DistMatrix:
    """:func:`sign_qdwh` of the grid matrix ``x`` (all of its n_m rows:
    padding with a sentinel on its diagonal stays decoupled)."""
    set_matmul_precision_highest()
    grid = x.grid
    m = x.n_m
    dt = x.local.dtype
    if l0 is None:
        l0 = 1e-16 if dt == torch.float64 else 1e-7
    eye = pm.local_eye(x)
    ss = pm.all_reduce((x.local * x.local).sum().reshape(1), grid)
    x = x.with_local(x.local / torch.clamp(torch.sqrt(ss[0]), min=1e-30))
    nr, nc = x.local.shape
    for a, b, c in qdwh_weights(l0):
        if c > qr_switch:
            sc = math.sqrt(c)
            whole = pm.gather(x)
            q, _ = torch.linalg.qr(torch.cat([sc * whole, torch.eye(
                m, dtype=dt, device=whole.device)], dim=0))
            del whole
            # this rank's block of q[:m] @ q[m:]^T
            prod = q[x.row0:x.row0 + nr] @ q[m + x.col0:m + x.col0 + nc].T
            del q
            x = x.with_local((b / c) * x.local + ((a - b / c) / sc) * prod)
        else:
            z = pm.matmul(x, x, panel=block)
            z = z.with_local(eye.local + c * z.local)
            l = blocked_cholesky(z, block, grid)
            w = trsm_lower(l, x, block=block, mesh=grid)
            y = pm.transpose(trsm_lower(l, w, transpose=True, block=block,
                                        mesh=grid))
            x = x.with_local((b / c) * x.local + (a - b / c) * y.local)
        x = symmetrize(x)
    return x


def _cholqr2_grid(y: pm.DistMatrix, block: int) -> pm.DistMatrix:
    """Two rounds of Cholesky-QR of the grid matrix ``y``: Y L^-T with L
    the factor of Y^T Y."""
    for _ in range(2):
        g = pm.matmul(y, y, trans_a=True, panel=block)
        l = blocked_cholesky(g, block, y.grid)
        y = trsm_right_lower_t(l, y, block=block, mesh=y.grid)
    return y


def _probe_grid(like: pm.DistMatrix, live: int, seed: int) -> pm.DistMatrix:
    """This rank's block of the probe: :func:`spectral_dc_eigh`'s G of a
    ``live`` block (``default_rng(seed + live)``, drawn in row chunks, each
    rank keeping its entries) with the identity on the padding."""
    rng = np.random.default_rng(seed + live)
    nr, nc = like.local.shape
    r0, c0 = like.row0, like.col0
    blk = np.zeros((nr, nc))
    r_end, c_end = min(r0 + nr, live), min(c0 + nc, live)
    for s in range(0, r_end, 256):
        e = min(s + 256, r_end)
        chunk = rng.standard_normal((e - s, live))
        a0 = max(s, r0)
        if a0 < e and c_end > c0:
            blk[a0 - r0:e - r0, :c_end - c0] = chunk[a0 - s:, c0:c_end]
    g = torch.as_tensor(blk, dtype=like.local.dtype, device=like.local.device)
    rows, cols = pm.global_index(like)
    g[(rows == cols) & (rows >= live)] = 1.0
    return like.with_local(g)


def _split_grid(a: pm.DistMatrix, live: int, sigma: float,
                g: pm.DistMatrix, otol: float, block: int):
    """:func:`_split` on the grid: (v, d, k) or None, every decision on
    values reduced over the grid (the same on every rank)."""
    grid = a.grid
    m = a.n_m
    eye = pm.local_eye(a)
    u = sign_qdwh_grid(a.with_local(a.local - sigma * eye.local),
                       block=block)
    k = int(torch.round((m - pm.diagonal(u).sum()) / 2))
    if not 0 < k < live:
        return None
    pg = pm.matmul(u, g, panel=block)
    del u
    pg = pg.with_local(0.5 * (g.local - pg.local))    # P_minus G
    rows, cols = pm.global_index(a)
    y = pg.with_local(torch.where(cols < k, pg.local, g.local - pg.local))
    del pg
    try:
        v = _cholqr2_grid(y, block)
    except NotPositiveDefiniteError:
        return None
    del y
    d = symmetrize(pm.matmul(v, pm.matmul(a, v, panel=block),
                             trans_a=True, panel=block))
    vtv = pm.matmul(v, v, trans_a=True, panel=block)
    live_blk = (rows < live) & (cols < live)
    worst = torch.stack([
        torch.where((rows >= k) & (cols < k), d.local.abs(), 0.0).max(),
        (vtv.local - eye.local).abs().max()])
    pm.all_reduce(worst, grid, op="max")
    del vtv
    ss = pm.all_reduce(torch.where(live_blk, a.local * a.local, 0.0).sum()
                       .reshape(1), grid)
    off, orth = float(worst[0]), float(worst[1])
    anorm = math.sqrt(float(ss[0]))
    if orth < otol and off <= otol * max(anorm, 1.0):
        return v, d, k
    return None


def spectral_dc_on_grid(a: pm.DistMatrix, base: int = 256, seed: int = 7,
                        block: int = GEMM_BLOCK) -> pm.ColumnShares:
    """:func:`spectral_dc_eigh` of the grid matrix ``a`` (its logical
    ``a.n`` pairs; the padding has the Gershgorin sentinel on its
    diagonal), as this rank's column shares (n_m rows).  The recursion
    tracks each block's live size, as the JAX function does: the sigma
    candidates are quantiles of the live diagonal and the probe is the
    identity on the padding (inherited and new)."""
    grid = a.grid
    dt = a.local.dtype
    otol = 5e-5 if dt == torch.float32 else 1e-10
    leaf = max(base, int(a.n / math.sqrt(grid.size)))

    def solve_whole(x: pm.DistMatrix, live: int, split: bool):
        blk = pm.gather_block(x, 0, live, 0, live)
        w, v = spectral_dc_eigh(blk, base, seed) if split else \
            torch.linalg.eigh(blk)
        del blk
        lo, hi = pm.share(live, grid.size, grid.rank)
        vm = v.new_zeros((x.n_m, hi - lo))
        vm[:live] = v[:, lo:hi]
        return w, vm, torch.arange(lo, hi, device=v.device)

    def rec(x: pm.DistMatrix, live: int):
        if live <= leaf:
            return solve_whole(x, live, True)
        diag = pm.diagonal(x)[:live].cpu().numpy()
        g = _probe_grid(x, live, seed)
        for q in _SIGMA_QUANTILES:
            split = _split_grid(x, live, float(np.quantile(diag, q)), g,
                                otol, block)
            if split is not None:
                break
        else:
            return solve_whole(x, live, False)
        v, d, k = split
        del g
        m = x.n_m
        kids = []
        for lo, hi, kid_live in ((0, k, k), (k, m, live - k)):
            sub = pm.submatrix(d, lo, hi)
            if sub.n_m > sub.n:
                sub = pm.fill_padding_diagonal(
                    sub, gershgorin_sentinel(sub, grid))
            kids.append(rec(sub, kid_live))
            del sub
        del d
        (w1, v1, c1), (w2, v2, c2) = kids
        # this rank's columns of v @ blockdiag(v1, v2)
        z = v1.new_zeros((m, v1.shape[1] + v2.shape[1]))
        z[:k, :v1.shape[1]] = v1[:k]
        z[k:, v1.shape[1]:] = v2[:m - k]
        del v1, v2
        return (torch.cat([w1, w2]), pm.times_columns(v, z),
                torch.cat([c1, k + c2]))

    w, vm, cols = rec(a, a.n)
    return pm.ColumnShares(w, vm, cols)
