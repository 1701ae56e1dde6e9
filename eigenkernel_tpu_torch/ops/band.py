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
panel may have fewer than ``bw`` rows below the band, so any n works.
Each panel's QR and its compact-WY T factor are :func:`panel_qr`: on a
CUDA tensor one launch of kernel D3 (``csrc/panel_qr.cu``; ``LAUNCHES``
counts them, one a panel), on a CPU tensor the plain :func:`_qr_panel`
and ``wy_t_factor``, D3's model.  (The
JAX package's bucketed recursion ``_to_band_rec``, ``EK_TOBAND_SPLIT`` and
``EK_QR_PANEL`` exist for XLA shapes and a TPU A/B; eager PyTorch needs
none of them.)  The GEMMs are ``torch.matmul`` (cuBLAS on the card), as the
JAX package leaves them to XLA.

On a process grid (``mesh=``, ``a`` a
:class:`~eigenkernel_tpu_torch.parallel.mesh.DistMatrix`; JAX
``ops/band.py:116-190``) each panel's (m - bw, bw) block below the band
is gathered whole onto every rank by one ``all_reduce`` and QR-factored
there; ``A V`` is the blocks' product summed into one zero-padded
``all_reduce`` of (m, bw) (``parallel.mesh.times_tall``); ``u`` is formed
on every rank, and each rank applies the rank-2b update to its own block,
in the form ``A[s:, s:] -= U Vf^T + Vf U^T`` with ``Vf = [0; V2]`` (the
three updates of the single-device loop in one).  Two collectives a
panel.  The reflectors are kept by WY group, one rank each
(``householder.GridReflectors``), and the band leaves the grid only as
its banded lower storage (:func:`banded_lower`), O(n bw) words summed
from each rank's diagonals: the replicated state the chase starts from.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from eigenkernel_tpu_torch.obs import events
from eigenkernel_tpu_torch.ops import build
from eigenkernel_tpu_torch.ops.householder import (GridReflectors,
                                                   _householder, apply_wy,
                                                   apply_wy_grid,
                                                   wy_groups, wy_t_factor)
from eigenkernel_tpu_torch.parallel import mesh as pm


LAUNCHES = 0        # launches of D3 by panel_qr (CPU tensors add none)

SMEM_BYTES = 232448  # shared memory a block may use on sm_90
ROWS_MIN = 128       # a D3 CTA takes at least this many rows where it can
_GROUPS, _WARPS = 8, 16  # csrc/panel_qr.cu kGroups, kWarps

_FN = {torch.float64: "ek_panel_qr_f64", torch.float32: "ek_panel_qr_f32"}


class BandResult(NamedTuple):
    band: Optional[torch.Tensor]  # (n, n) band matrix; None once the chase
                                  # has read it (None on a grid)
    V: Any              # (n, n) reflectors; column s+j pivots at row s+bw+j
    #                     (a GridReflectors on a process grid)
    taus: torch.Tensor  # (n,)   reflector coefficients (0 => identity)
    bw: int
    lower: Optional[torch.Tensor] = None  # on a grid: the band's banded
    #                     lower storage (n + 2bw, 2bw + 1), every rank


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


def panel_qr_plain(p: torch.Tensor):
    """D3's model: ``(V2, taus, T)`` of the (m, b) panel ``p`` (not
    modified) by :func:`_qr_panel` and ``wy_t_factor``, on any device."""
    v2, tp = _qr_panel(p.clone())
    return v2, tp, wy_t_factor(v2, tp)


def panel_smem_bytes(rows: int, b: int, itemsize: int) -> int:
    """Shared memory of a D3 CTA of ``rows`` rows at panel width ``b``: the
    rows at a pitch of b + 1 (or T's back substitution, if larger), the
    row groups' sums, a word a warp and w (``panel_qr.cu::smem_words``)."""
    w = b + 1
    return (max(rows * w, b * w + b) + _GROUPS * w + _WARPS + b) * itemsize


def panel_plan(m: int, sms: int = 132):
    """``(grid, rows)`` of D3 on a panel of m rows: ceil(m / ROWS_MIN)
    CTAs, at most one an SM (fewer CTAs keep a small panel's barriers
    cheap), ``rows`` = ceil(m / grid) rows each."""
    grid = max(1, min(sms, -(-m // ROWS_MIN)))
    return grid, -(-m // grid)


def panel_qr(p: torch.Tensor):
    """Householder QR of the (m, b) panel ``p`` (not modified) with its
    compact-WY factor: ``(V2, taus, T)``, V2 (m, b) with column j's unit
    pivot (0 for an identity reflector) at row j and zeros above, taus
    (b,), T (b, b) upper with ``H_0 ... H_{b-1} = I - V2 T V2^T``.  A CUDA
    tensor launches D3 once, a CPU tensor runs :func:`panel_qr_plain`."""
    if p.dtype not in _FN:
        raise TypeError(f"panel_qr: dtype {p.dtype} not float32/float64")
    if p.dim() != 2 or p.shape[0] < 1 or p.shape[1] < 1:
        raise ValueError(f"panel_qr: a non-empty (m, b) panel expected, "
                         f"got {tuple(p.shape)}")
    if p.device.type == "cpu":
        return panel_qr_plain(p)
    if p.device.type != "cuda":
        raise ValueError(f"panel_qr: unsupported device {p.device}")
    if p.stride(1) != 1:
        p = p.contiguous()
    sms = torch.cuda.get_device_properties(p.device).multi_processor_count
    return _launch(p, *panel_plan(p.shape[0], sms))


def _launch(p: torch.Tensor, grid: int, rows: int):
    """D3 on the CUDA panel ``p`` (unit column stride) with ``grid`` CTAs
    of ``rows`` rows (``rows * grid >= m``); any grid that can be
    co-resident (the card tests and ``chip_smoke.py`` take others than
    :func:`panel_plan`'s)."""
    global LAUNCHES
    m, b = p.shape
    smem = panel_smem_bytes(rows, b, p.element_size())
    if smem > SMEM_BYTES:
        raise build.KernelLaunchError(
            f"panel_qr: a ({m}, {b}) panel needs {smem} bytes of shared "
            f"memory a CTA ({grid} CTAs of {rows} rows), more than "
            f"{SMEM_BYTES}")
    v2 = torch.empty((m, b), dtype=p.dtype, device=p.device)
    taus = torch.empty(b, dtype=p.dtype, device=p.device)
    t = torch.empty((b, b), dtype=p.dtype, device=p.device)
    part = torch.empty(2 * grid * (b + 1) + 2 * b, dtype=p.dtype,
                       device=p.device)
    bar = torch.zeros(1, dtype=torch.int32, device=p.device)
    name = _FN[p.dtype]
    stream = torch.cuda.current_stream(p.device).cuda_stream
    ld = p.stride(0) if m > 1 else b
    status = getattr(build.library(), name)(
        p.data_ptr(), ld, m, b, rows, grid, v2.data_ptr(),
        taus.data_ptr(), t.data_ptr(), part.data_ptr(), bar.data_ptr(),
        stream)
    build.check(status, name)
    LAUNCHES += 1
    return v2, taus, t


def to_band(a, bw: int, mesh: Optional[pm.ProcessGrid] = None) -> BandResult:
    """Reduce symmetric ``a`` to a band matrix ``Q^T A Q`` of semibandwidth
    ``bw``.  ``a`` is not modified.  With ``mesh``, ``a`` is a DistMatrix
    and the result carries the band as ``lower`` (module doc)."""
    if bw < 1:
        raise ValueError(f"to_band: bandwidth must be >= 1, got {bw}")
    if mesh is not None:
        return _to_band_grid(a, bw, mesh)
    n = a.shape[0]
    dtype, dev = a.dtype, a.device
    A = a.clone()
    V = torch.zeros((n, n), dtype=dtype, device=dev)
    taus = torch.zeros(n, dtype=dtype, device=dev)
    for s in range(0, max(n - bw, 0), bw):
        As = A[s:, s:]                     # trailing block, a view of A
        with events.span("to_band:panel"):
            V2, tp, t = panel_qr(As[bw:, :bw])
        with events.span("to_band:update"):
            av = As[:, bw:] @ V2           # A V, V = [0; V2]
            u = av @ t
            u[bw:] -= 0.5 * (V2 @ (t.T @ (V2.T @ av[bw:]) @ t))
            u1, u2 = u[:bw], u[bw:]
            # one concatenated rank-2b GEMM on the trailing block, as the
            # JAX package does: u2 V2^T + V2 u2^T = [u2 V2] [V2 u2]^T
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


def _to_band_grid(a: pm.DistMatrix, bw: int,
                  grid: pm.ProcessGrid) -> BandResult:
    """The loop of :func:`to_band` on plain blocks (module doc)."""
    if a.grid is not grid:
        raise ValueError("to_band: the matrix is on another grid")
    A = a.local.clone()
    x = a.with_local(A)
    n = a.n_m
    dtype, dev = A.dtype, A.device
    taus = torch.zeros(n, dtype=dtype, device=dev)
    groups = wy_groups(n, bw, grid.size)
    mine = {i: torch.zeros((n - gs, w), dtype=dtype, device=dev)
            for i, (gs, w) in enumerate(groups) if i % grid.size == grid.rank}
    gb = groups[0][1]                      # a multiple of bw
    for s in range(0, max(n - bw, 0), bw):
        m = n - s
        with events.span("to_band:panel"):
            V2, tp, t = panel_qr(pm.gather_block(x, s + bw, n, s, s + bw))
        with events.span("to_band:update"):
            av = pm.times_tall(x, V2, (s, n), (s + bw, n))  # A V, (m, bw)
            u = av @ t
            u[bw:] -= 0.5 * (V2 @ (t.T @ (V2.T @ av[bw:]) @ t))
            a0, a1 = x.rows(s, n)
            b0, b1 = x.cols(s, n)
            if a1 > a0 and b1 > b0:
                vf = torch.zeros_like(u)
                vf[bw:] = V2
                uv = torch.cat([u, vf], dim=1)
                vu = torch.cat([vf, u], dim=1)
                A[a0:a1, b0:b1].addmm_(
                    uv[x.row0 + a0 - s:x.row0 + a1 - s],
                    vu[x.col0 + b0 - s:x.col0 + b1 - s].T, alpha=-1.0)
            i = s // gb
            if i in mine:
                gs = groups[i][0]
                mine[i][s + bw - gs:, s - gs:s - gs + bw] = V2
            taus[s:s + bw] = tp
    return BandResult(band=None, V=GridReflectors(groups, mine), taus=taus,
                      bw=bw, lower=banded_lower(x, bw))


def banded_lower(x: pm.DistMatrix, bw: int) -> torch.Tensor:
    """The banded lower storage ``lb[i, q] = band[i, i + q - 2bw]`` (n_m +
    2bw rows, the chase's state, ``bulge._to_banded``) of the band of
    ``x``, ``band = (A + A^T) / 2`` on |i - j| <= bw, whole on every rank:
    each rank adds half of each entry of its block's 2bw + 1 diagonals at
    the entry's place and at its mirror's, and one ``all_reduce`` sums
    them (each sum has two nonzero halves, so it is exact in any order
    and equal to the single-device ``(A + A^T) * 0.5``)."""
    n = x.n_m
    blk = x.local
    lb = blk.new_zeros((n + 2 * bw, 2 * bw + 1))
    nr, nc = blk.shape
    for off in range(-bw, bw + 1):          # off = j - i
        k = off + x.row0 - x.col0           # the block diagonal holding it
        if not -nr < k < nc:
            continue
        half = torch.diagonal(blk, k) * 0.5
        i = x.row0 + max(0, -k) + torch.arange(half.shape[0],
                                               device=blk.device)
        if off <= 0:                        # (i, j) in the lower half
            lb[i, off + 2 * bw] += half
        if off >= 0:                        # its mirror (j, i)
            lb[i + off, 2 * bw - off] += half
    return pm.all_reduce(lb, x.grid)


def apply_band_q(res: BandResult, z: torch.Tensor, block: int = 64,
                 mesh: Optional[pm.ProcessGrid] = None) -> torch.Tensor:
    """``z <- Q z`` with Q the stage-1 band-reduction transform: groups of
    panels as compact-WY products, last to first (see
    :func:`eigenkernel_tpu_torch.ops.householder.apply_wy`); on a grid
    ``z`` is a rank's own columns and each group is broadcast from its
    rank in turn.  Returns a new tensor."""
    with events.span("bt:band"):
        if mesh is not None:
            return apply_wy_grid(res.V, res.taus, z, mesh)
        return apply_wy(res.V, res.taus, z, block)
