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

On a process grid :func:`refine_on_grid` runs the same steps on the
grid's column shares (the JAX function's ``mesh=`` products, written as
streams of broadcasts).
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from eigenkernel_tpu_torch.parallel import mesh as pm

PASSES = 6          # adjacent-pair Jacobi passes of the cluster cleanup


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
        tiny = _threshold(scale, f.abs().max(), gap_factor, floor,
                          tiny_prev)
        tiny_prev = tiny
        e = _correction(s, f, lam, dl, tiny, eye == 1)
        v = v + v @ e
    # cluster cleanup: the members of a near-degenerate cluster are
    # adjacent in the sorted spectrum, so adjacent-pair Jacobi passes on
    # S = V^T A V diagonalize every cluster, then one V @ J product
    s, j_rot = _adjacent_jacobi(v.T @ (a @ v), passes=PASSES)
    v = v @ j_rot
    lam = s.diagonal()
    if b is not None:
        lam = lam / (v * (b @ v)).sum(dim=0)
    order = torch.argsort(lam, stable=True)
    return lam[order], v[:, order]


def _threshold(scale, err_est, gap_factor: float, floor: float,
               tiny_prev):
    """The cluster threshold: pairs with a gap below ~the current error
    (the orthonormality defect ``err_est``, contraction-aware as sqrt)
    count as one eigenspace; it never grows, which breaks the period-2
    limit cycle of re-frozen marginal pairs (the JAX function's notes)."""
    tiny = scale * torch.clamp(torch.sqrt(gap_factor * err_est), min=floor)
    return tiny if tiny_prev is None else torch.minimum(tiny, tiny_prev)


def _correction(s, f, lam_cols, dl, tiny, diag):
    """The Newton correction E of the columns of S and F = I - R whose
    eigenvalues are ``lam_cols``: ``dl`` = lambda_j - lambda_i, ``diag``
    marks the diagonal entries (E_ii = F_ii / 2)."""
    safe = dl.abs() > tiny
    e_off = torch.where(safe, (s + f * lam_cols[None, :])
                        / torch.where(safe, dl, 1.0), f * 0.5)
    return torch.where(diag, f * 0.5, e_off)


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


def _angles(app, aqq, apq):
    """(c, s) of the Jacobi rotations that zero ``apq`` in the 2 x 2
    blocks [[app, apq], [apq, aqq]] (none where |apq| <= tiny)."""
    tiny = torch.finfo(app.dtype).tiny
    safe = apq.abs() > tiny
    tau = (aqq - app) / torch.where(safe, 2.0 * apq, 1.0)
    tau = torch.clamp(tau, -1e18, 1e18)
    sign = torch.where(tau >= 0, 1.0, -1.0).to(app.dtype)
    t = torch.where(safe, sign / (tau.abs() + torch.sqrt(1.0 + tau * tau)),
                    0.0)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, t * c


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
    for i in range(passes):
        parity = i % 2
        npair = (k - parity) // 2
        if npair == 0:
            # k == 2, parity 1: no adjacent pair starts at index 1
            continue
        p = torch.arange(parity, parity + 2 * npair, 2, device=s.device)
        c, sn = _angles(s[p, p], s[p + 1, p + 1], s[p, p + 1])
        s = _rot_rows(_rot_rows(s, parity, c, sn).T, parity, c, sn).T
        j_acc = _rot_rows(j_acc.T, parity, c, sn).T
    return s, j_acc


# ---------------------------------------------------------------------------
# on a process grid
# ---------------------------------------------------------------------------

def refine_on_grid(a: pm.DistMatrix, v: pm.ColumnShares,
                   b: Optional[pm.DistMatrix] = None,
                   steps: Optional[int] = None,
                   gap_factor: float = 30.0) -> pm.ColumnShares:
    """:func:`refine_eigenpairs` on a process grid (JAX
    ``refine_eigenpairs(mesh=)``): ``a`` (and ``b``) float64 DistMatrix,
    ``v`` the float32 pipeline's :class:`ColumnShares` (n_m rows, zero on
    the padding); returns the refined ColumnShares, float64, each rank
    keeping its own columns (their places ``cols`` re-sorted by the new
    eigenvalues; no column moves).

    Every product is a stream of broadcasts, so no rank holds more than
    its share of a matrix and one other share: ``A V`` (and ``B V``) by
    :func:`~eigenkernel_tpu_torch.parallel.mesh.times_columns`, each
    rank's block of A in turn; ``V^T (A V)``, ``V^T (B V)`` and ``V E``,
    with S, R, E (k x k) in the same column shares as V, each rank's
    columns of V in turn.  lambda and the diagonals are gathered (O(k)).
    The cluster cleanup's angles and its new diagonal come from a band
    of S gathered whole (k x (2 H + 1), H = 2 PASSES + 2), on band
    storage (:func:`_adjacent_jacobi_band`); V J is one more stream of
    V's columns, with J in column shares.
    """
    if steps is None:
        steps = int(os.environ.get("EK_REFINE_STEPS", "8"))
    grid = a.grid
    dtype = a.local.dtype
    vm = v.vectors.to(dtype)
    mine = v.cols
    k, w = v.values.shape[0], vm.shape[1]
    dev = vm.device
    # every rank's width and places: the shapes of the column streams
    widths = pm.gather_slots(torch.tensor([w], device=dev), grid.rank,
                             (grid.size,), grid).tolist()
    offs = [sum(widths[:q]) for q in range(grid.size)]
    places = pm.gather_slots(mine, slice(offs[grid.rank],
                                         offs[grid.rank] + w), (k,), grid)
    places = [places[o:o + wq] for o, wq in zip(offs, widths)]
    shapes = [(vm.shape[0], wq) for wq in widths]

    def gram(*zs):
        """V^T z (k, w) for each z (n_m, w): one stream of V's columns."""
        out = [z.new_zeros((k, w)) for z in zs]
        for q, vq in pm.rank_shares(vm, grid, shapes):
            for o, z in zip(out, zs):
                o[places[q]] = vq.T @ z
        return out

    def times(e):
        """V e, e (k, w) this rank's columns of a k x k matrix."""
        out = torch.zeros_like(vm)
        for q, vq in pm.rank_shares(vm, grid, shapes):
            out += vq @ e[places[q]]
        return out

    j = torch.arange(w, device=dev)
    diag = torch.arange(k, device=dev)[:, None] == mine[None, :]
    finfo = torch.finfo(dtype)
    floor = 100.0 * math.sqrt(finfo.eps)
    tiny_prev = None
    for _ in range(steps):
        av = pm.times_columns(a, vm)
        bv = pm.times_columns(b, vm) if b is not None else vm
        s, r = gram(av, bv)
        del av, bv
        lam_m = s[mine, j] / r[mine, j]
        lam = pm.gather_slots(lam_m, mine, (k,), grid)
        f = diag.to(dtype) - r
        del r
        err = pm.all_reduce(f.abs().max().reshape(1), grid, op="max")[0]
        scale = torch.clamp(lam.max() - lam.min(), min=finfo.tiny)
        tiny = _threshold(scale, err, gap_factor, floor, tiny_prev)
        tiny_prev = tiny
        e = _correction(s, f, lam_m, lam_m[None, :] - lam[:, None], tiny,
                        diag)
        del s, f
        vm = vm + times(e)
        del e
    # the cluster cleanup from a band of S: its angles and new diagonal
    (s,) = gram(pm.times_columns(a, vm))
    half = 2 * PASSES + 2
    t = torch.arange(2 * half + 1, device=dev)
    rows = mine[:, None] + t[None, :] - half           # (w, 2H + 1)
    ok = (rows >= 0) & (rows < k)
    part = torch.where(ok, s[rows.clamp(0, k - 1), j[:, None]], 0.0)
    band = pm.gather_slots(part, mine, (k, 2 * half + 1), grid)
    del s
    lam, jband = _adjacent_jacobi_band(band, half)
    jm = vm.new_zeros((k, w))
    jm[rows[ok], j[:, None].expand_as(rows)[ok]] = jband[mine][ok]
    vm = times(jm)
    del jm
    if b is not None:
        bv = pm.times_columns(b, vm)
        lam = lam / pm.gather_slots((vm * bv).sum(dim=0), mine, (k,), grid)
        del bv
    order = torch.argsort(lam, stable=True)
    place = torch.empty_like(order)
    place[order] = torch.arange(k, device=dev)
    return pm.ColumnShares(lam[order], vm, place[mine])


def _flip(r: torch.Tensor) -> torch.Tensor:
    """The band of X^T from the band of X, both stored by rows:
    ``r[i, d + H] = X[i, i + d]`` for |d| <= H, zero past the ends."""
    k, width = r.shape
    half = width // 2
    t = torch.arange(width, device=r.device)
    i = torch.arange(k, device=r.device)[:, None] + t[None, :] - half
    ok = (i >= 0) & (i < k)
    return torch.where(ok, r[i.clamp(0, k - 1), (2 * half - t).expand(k, -1)],
                       0.0)


def _band_rot_rows(r: torch.Tensor, lo: int, c: torch.Tensor,
                   sn: torch.Tensor) -> torch.Tensor:
    """:func:`_rot_rows` on a band stored by rows (``r[i, d + H] =
    X[i, i + d]``): the same products on the entries the band holds, an
    entry past the band read as 0."""
    npair = c.shape[0]
    p = torch.arange(lo, lo + 2 * npair, 2, device=r.device)
    rp, rq = r[p], r[p + 1]
    zero = r.new_zeros((npair, 1))
    c, sn = c[:, None], sn[:, None]
    out = r.clone()
    out[p] = c * rp - sn * torch.cat([zero, rq[:, :-1]], dim=1)
    out[p + 1] = sn * torch.cat([rp[:, 1:], zero], dim=1) + c * rq
    return out


def _adjacent_jacobi_band(band: torch.Tensor, half: int):
    """The diagonal of ``J^T S J`` and the band of J (``jband[c, t] =
    J[c + t - half, c]``) of :func:`_adjacent_jacobi` (PASSES passes) from
    the band ``band[c, t] = S[c + t - half, c]`` of S, on band storage:
    the same angles and rotations, each half-pass (rows, then columns as
    the rows of the transpose) on the band alone.  An entry past the
    band is read as 0, so an entry d from the diagonal may differ from
    the whole matrix's after a pass; the difference moves at most two
    places nearer the diagonal a pass, so with half >= 2 PASSES + 2 the
    angles (from the diagonal and the first off-diagonal) and the last
    diagonal are the whole matrix's, bit for bit."""
    k = band.shape[0]
    r = _flip(band)                              # S by rows
    jt = torch.zeros_like(r)                     # J^T by rows
    jt[:, half] = 1.0
    for i in range(PASSES if k >= 2 else 0):
        parity = i % 2
        npair = (k - parity) // 2
        if npair == 0:
            continue
        p = torch.arange(parity, parity + 2 * npair, 2, device=r.device)
        c, sn = _angles(r[p, half], r[p + 1, half], r[p, half + 1])
        r = _flip(_band_rot_rows(_flip(_band_rot_rows(r, parity, c, sn)),
                                 parity, c, sn))
        jt = _band_rot_rows(jt, parity, c, sn)
    return r[:, half].clone(), jt
