"""Mixed-precision eigenpair refinement (Ogita-Aishima Newton iteration).

Counterpart of ``eigenkernel_tpu/ops/refine.py`` (``refine_eigenpairs``),
with another cluster cleanup (below).  ``dtype='mixed'`` runs the pipeline in
float32 and refines its eigenpairs here against float64 copies of the
caller's matrices.  Per step, with V the approximate eigenvector block:

    R = V^T B V,  S = V^T A V,  lambda_j = S_jj / R_jj,  F = I - R
    E_ij = (S_ij + F_ij lambda_j) / (lambda_j - lambda_i)   (i != j)
    E_ii = F_ii / 2,   V <- V (I + E)

(Newton's method on V^T B V = I, offdiag(V^T A V) = 0).  Pairs whose gap
is below an adaptive, monotone threshold count as one eigenspace and
get only the symmetric F/2 part; the cleanup then diagonalizes those
clusters.

The cleanup departs from the JAX package's, which runs six adjacent-pair
Jacobi passes on V^T A V in the columns' own order.  Those leave a
cluster unresolved where its members are not neighbours in that order
(a float32 start orders its columns by eigenvalues only as well as
float32 resolves them) or where a coupling sits between two members
that are not neighbours (the rotations of the pairs between them are
then ~0 and never carry it): on the H100 at n = 22,500 (1,318
clustered pairs) the eigenvalues stalled at 3e-8 of max |lambda| and the
residuals at 1e-7 whatever the step count.  Here (part II of Ogita and
Aishima, a cluster's small eigenproblem solved whole) the columns are
put in ascending order of the last step's eigenvalues, so that a
cluster's members are neighbours, and two passes of exact eigh of
W x W diagonal blocks of V^T A V (W = ``WINDOW``, less at small k:
:func:`_window`), the second offset by half a window, diagonalize every
cluster of up to W / 2 + 1 members whole; V J is one batched product of
the blocks (:func:`_rayleigh_ritz`).  Before them one orthogonalization,
V <- V (I + F / 2): it divides by no gap, so it takes out the defect the
Newton steps leave where they divide the rounding of S_ij + F_ij
lambda_j by a gap just above the threshold (at n = 22,500 on the H100
they stopped at an orthogonality of 3e-11, where the float64 solve
reaches 2.5e-14).

The same solve runs once on the start, before the Newton steps: a
float32 start couples its neighbours up to float32's resolution of
their gaps, and a Newton step that starts from a coupling comparable
to its gap overshoots.  Without it, the steps after the threshold falls
to its floor lost orthogonality (1.8e-3 after 4 steps at n = 22,500)
and some starts needed more than nine steps; with it, the Newton steps
start from couplings across windows only.

Only the native float64 GEMM branch is ported: the card multiplies in
float64 natively, so the Ozaki slice products (``EK_REFINE_GEMM``,
``EK_REFINE_OZAKI_SCHED[_BIG]``) and the column-blocked large-n variants
(``refine_stepwise``, ``EK_REFINE_STEPWISE``, ``EK_REFINE_CHUNK_MIN``,
``EK_REFINE_NC``, ``EK_REFINE_CLEANUP``, ``EK_REFINE_CLUSTER_CAP``),
which exist for the TPU's emulated float64 and its
16 GB of memory, are left out.  ``EK_REFINE_STEPS`` is read as in the
JAX package, with another default: 8, not 6 (``STEPS``).  On the H100
at n = 4096 (an ELSES-style matrix, the float32 ``scalapack`` start)
six steps of the adjacent-pair cleanup left a residual of 6.5e-10 and
eight 4.3e-13; ``chip_smoke.py`` phase 12 prints the n = 22,500
refinement after 4 to 8 steps.

On a process grid :func:`refine_on_grid` runs the same steps on the
grid's column shares (the JAX function's ``mesh=`` products, written as
streams of broadcasts) and the same window solves, their blocks of
V^T A V gathered whole, with the orthogonalization at the start only.

Spans and counters (``obs/events.py``, recorded only when a solve has a
log): ``refine:start`` the start's window solve, ``refine:step`` a
Newton step, ``refine:cleanup`` the cluster cleanup with V J and the
final eigenvalues; counters ``refine:steps``
(the steps run) and ``refine:clustered`` (the neighbouring pairs, in
ascending order of the last step's eigenvalues, whose gap is at or below
its threshold: the work left to the cleanup), whose one host read is the
span ``wait:refine_clustered``.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from eigenkernel_tpu_torch.obs import events
from eigenkernel_tpu_torch.parallel import mesh as pm

WINDOW = 32         # columns a block of the cleanup's eigh (module doc)
STEPS = 8           # Newton steps, unless EK_REFINE_STEPS says otherwise


def refine_eigenpairs(a: torch.Tensor, v: torch.Tensor,
                      b: Optional[torch.Tensor] = None,
                      steps: Optional[int] = None,
                      gap_factor: float = 30.0):
    """Refine approximate eigenvectors ``v`` (columns) of ``A [x = lam B x]``
    in the dtype of ``a`` (pass float64 matrices to refine float32
    results); ``v`` is promoted.

    ``steps=None`` reads ``EK_REFINE_STEPS`` (default 8); ``steps=0`` runs
    only the window solves, the start's and the cleanup's.  Returns
    (values ascending, vectors [B-]orthonormal to working precision).
    """
    if steps is None:
        steps = int(os.environ.get("EK_REFINE_STEPS", STEPS))
    dtype = a.dtype
    v = v.to(dtype)
    if b is not None:
        b = b.to(dtype)
    k = v.shape[1]
    eye = torch.eye(k, dtype=dtype, device=a.device)
    finfo = torch.finfo(dtype)
    floor = 100.0 * math.sqrt(finfo.eps)
    tiny_prev = lam = None
    # the start's neighbours are coupled up to float32's resolution of
    # their gaps: solve them within the windows first, so that no Newton
    # step starts from a coupling comparable to its gap
    with events.span("refine:start"):
        _, v = _rayleigh_ritz(a, b, v)
    for _ in range(steps):
        with events.span("refine:step"):
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
            del s, r, f, dl, e
    del eye
    _count(steps, lam, tiny_prev)
    # cluster cleanup (module doc), the columns in ascending order
    with events.span("refine:cleanup"):
        lam, v = _rayleigh_ritz(
            a, b, v, None if lam is None else torch.argsort(lam, stable=True))
        if b is not None:
            lam = lam / (v * (b @ v)).sum(dim=0)
        order = torch.argsort(lam, stable=True)
    return lam[order], v[:, order]


def _rayleigh_ritz(a, b, v, order=None):
    """One orthogonalization V <- V (I + F / 2), the columns put in
    ``order`` (ascending eigenvalues; None: as they are), then the
    windows' eigh of V^T A V and V J (module doc): returns (the windows'
    eigenvalues, V J)."""
    f = v.T @ (b @ v if b is not None else v)
    f.neg_()
    f.diagonal().add_(1.0)                        # F = I - R, in R's place
    v = v + v @ f.mul_(0.5)
    del f
    if order is not None:
        v = v[:, order]
    lam, jb = _window_eigh(v.T @ (a @ v))
    return lam, _times_windows(v, jb)


def _window(k: int) -> int:
    """The cleanup's window W: ``WINDOW``, or at small k the largest power
    of two up to k / 32 (at least 4), so that the blocks a grid rank
    gathers whole (4 W k words) stay within an eighth of the Gram matrix."""
    w = 4
    while w < WINDOW and 2 * w <= k / 32:
        w *= 2
    return w


def _pairs_index(k: int, w: int, device) -> torch.Tensor:
    """The real indices (T + 1, 2 W) of the pairs of pass-1 windows of
    :func:`_window_passes` (T = ceil(k / W)); those outside 0 .. k - 1
    are pads."""
    t = -(-k // w)
    return torch.arange(t + 1, device=device)[:, None] * w \
        + torch.arange(2 * w, device=device)[None, :] - w


def _window_eigh(s: torch.Tensor):
    """:func:`_window_passes` on symmetric ``s`` (k x k, its columns in
    ascending order)."""
    k = s.shape[0]
    w = _window(k)
    i = _pairs_index(k, w, s.device)
    real = (i >= 0) & (i < k)
    ic = i.clamp(0, k - 1)
    g = torch.where(real[:, :, None] & real[:, None, :],
                    s[ic[:, :, None], ic[:, None, :]], 0.0)
    return _window_passes(g, k, w)


def _window_passes(g: torch.Tensor, k: int, w: int):
    """The cleanup's two passes (module doc) on the blocks ``g`` (T + 1,
    2 W, 2 W) of S at :func:`_pairs_index` (zero on the pads): returns
    (the eigenvalues, k, in the columns' new order; the blocks of J,
    (T + 1, 2 W, W)).

    Indices are padded by one window in front and at least one behind,
    the pads on the diagonal below and above the whole spectrum,
    uncoupled, so that each block's eigh keeps them apart and at its
    ends.  Pass 1 solves the windows [u W, u W + W) of the padded
    indices, pass 2 those of the rotated S at [u W + W/2, u W + 3W/2),
    u = 0 .. T, each within the pair of pass-1 windows u, u + 1: block u
    of J holds its rows u W .. u W + 2W (padded) and the columns of
    pass-2 window u, whose real indices start at u W - W/2."""
    h = w // 2
    i = _pairs_index(k, w, g.device)
    real = (i >= 0) & (i < k)
    top = 2.0 * g.diagonal(dim1=1, dim2=2).abs().max() + 1.0
    pad = torch.where(i < 0, -top * (2.0 - i / (4 * w)),
                      top * (1.0 + (i - k + 1) / (4 * w)))
    g = g + torch.diag_embed(torch.where(real, 0.0, pad))
    # pass 1: each window; window T + 1 is the second half of pair T
    _, q1 = torch.linalg.eigh(torch.cat([g[:, :w, :w], g[-1:, w:, w:]]))
    qb = g.new_zeros(g.shape)
    qb[:, :w, :w] = q1[:-1]
    qb[:, w:, w:] = q1[1:]
    mid = qb[:, :, h:h + w]                                # (T+1, 2W, W)
    # pass 2: the windows straddling the pairs, in the rotated basis
    e2, q2 = torch.linalg.eigh(mid.transpose(1, 2) @ g @ mid)
    return e2.reshape(-1)[h:h + k], mid @ q2


def _times_windows(v: torch.Tensor, jb: torch.Tensor) -> torch.Tensor:
    """V J for the blocks ``jb`` of :func:`_window_eigh`: each pass-2
    window's columns from V's columns of its pair of pass-1 windows."""
    k = v.shape[1]
    blocks, w2, w = jb.shape
    vp = torch.nn.functional.pad(v, (w, (blocks + 1) * w - w - k))
    out = vp[:, :blocks * w].reshape(-1, blocks, w).transpose(0, 1) \
        @ jb[:, :w]
    out += vp[:, w:(blocks + 1) * w].reshape(-1, blocks, w) \
        .transpose(0, 1) @ jb[:, w:]
    h = w // 2
    return out.transpose(0, 1).reshape(v.shape[0], -1)[:, h:h + k]


def _count(steps: int, lam, tiny) -> None:
    """The counters ``refine:steps`` and ``refine:clustered`` of the
    active log (module doc), from the last step's eigenvalues ``lam`` and
    threshold ``tiny``; no host read without a log, and no clustered
    count without a step."""
    if not events.active():
        return
    events.count("refine:steps", steps)
    if steps > 0:
        lam = torch.sort(lam).values
        with events.span("wait:refine_clustered"):
            n = int((lam[1:] - lam[:-1] <= tiny).sum())
        events.count("refine:clustered", n)


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
    The window solves (the start's, with an orthogonalization, and the
    cleanup's, the places renumbered in ascending order of the last
    step's eigenvalues) take the blocks of S gathered whole
    (:func:`_gather_pairs`, 4 W k words), every rank alike; V J is one
    more stream of V's columns, with J in column shares.
    """
    if steps is None:
        steps = int(os.environ.get("EK_REFINE_STEPS", STEPS))
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

    def ritz(order=None, orth=False):
        """:func:`_rayleigh_ritz` on the grid: the places renumbered in
        ``order``, the windows from the blocks of S gathered whole, J in
        column shares; the orthogonalization only where ``orth``."""
        nonlocal vm, mine, places
        if orth:
            (r,) = gram(pm.times_columns(b, vm) if b is not None else vm)
            vm = vm + times(0.5 * (diag.to(dtype) - r))
            del r
        if order is not None:
            rank_of = torch.empty(k, dtype=mine.dtype, device=dev)
            rank_of[order] = torch.arange(k, dtype=mine.dtype, device=dev)
            mine = rank_of[mine]
            places = [rank_of[p] for p in places]
        (s,) = gram(pm.times_columns(a, vm))
        win = _window(k)
        pairs = _pairs_index(k, win, dev)
        lam, jb = _window_passes(
            _gather_pairs(s, mine, pairs, k, grid), k, win)
        del s
        # this rank's columns of J: pass-2 window u, slot c of a place
        u, c = (mine + win // 2) // win, (mine + win // 2) % win
        rows = pairs[u]                                    # (w, 2W)
        ok = (rows >= 0) & (rows < k)
        jm = vm.new_zeros((k, w))
        jm[rows[ok], j[:, None].expand_as(rows)[ok]] = jb[
            u[:, None], torch.arange(2 * win, device=dev), c[:, None]][ok]
        vm = times(jm)
        return lam

    tiny_prev = lam = None
    with events.span("refine:start"):
        ritz(orth=True)
    for _ in range(steps):
        with events.span("refine:step"):
            av = pm.times_columns(a, vm)
            bv = pm.times_columns(b, vm) if b is not None else vm
            s, r = gram(av, bv)
            del av, bv
            lam_m = s[mine, j] / r[mine, j]
            lam = pm.gather_slots(lam_m, mine, (k,), grid)
            f = diag.to(dtype) - r
            del r
            err = pm.all_reduce(f.abs().max().reshape(1), grid,
                                op="max")[0]
            scale = torch.clamp(lam.max() - lam.min(), min=finfo.tiny)
            tiny = _threshold(scale, err, gap_factor, floor, tiny_prev)
            tiny_prev = tiny
            e = _correction(s, f, lam_m, lam_m[None, :] - lam[:, None],
                            tiny, diag)
            del s, f
            vm = vm + times(e)
            del e
    _count(steps, lam, tiny_prev)
    # the cluster cleanup (module doc), the places in ascending order
    with events.span("refine:cleanup"):
        lam = ritz(None if lam is None else torch.argsort(lam, stable=True))
        if b is not None:
            bv = pm.times_columns(b, vm)
            lam = lam / pm.gather_slots((vm * bv).sum(dim=0), mine, (k,),
                                        grid)
            del bv
        order = torch.argsort(lam, stable=True)
    place = torch.empty_like(order)
    place[order] = torch.arange(k, device=dev)
    return pm.ColumnShares(lam[order], vm, place[mine])


def _gather_pairs(s: torch.Tensor, mine: torch.Tensor, pairs: torch.Tensor,
                  k: int, grid) -> torch.Tensor:
    """The blocks of :func:`_window_passes` gathered whole from this
    rank's columns ``s`` (k, w) of S at places ``mine``: each column of
    S lies in two pairs of pass-1 windows (one at the ends), whose
    entries it fills by column."""
    nb, w2 = pairs.shape
    part, slots = [], []
    for first in (0, 1):
        u = mine // (w2 // 2) + first               # the pair holding it
        ok = u < nb
        rows = pairs[u[ok]]                         # (m, 2W) real rows
        real = (rows >= 0) & (rows < k)
        col = s[:, ok].T                            # (m, k)
        part.append(torch.where(real, col.gather(1, rows.clamp(0, k - 1)),
                                0.0))
        slots.append(u[ok] * w2 + mine[ok] - pairs[u[ok], 0])
    g = pm.gather_slots(torch.cat(part), torch.cat(slots), (nb * w2, w2),
                        grid)
    return g.reshape(nb, w2, w2).transpose(1, 2).contiguous()
