"""Two-stage reduction, stage 2: band -> tridiagonal by bulge chasing.

Counterpart of the single-device parts of ``eigenkernel_tpu/ops/bulge.py``
(Lang/Schwarz Householder chasing, the second stage of ELPA2 and eigen_sx).
For each sweep c, a length-bw Householder with its pivot at the band edge
eliminates the sub-band entries of column c; the two-sided window update
creates a bulge one block down, whose first column the next chase step of
the sweep, at p + bw, eliminates.

The chase reflectors are stored per (sweep, position): ``HV[c, t]`` acts on
rows ``[c+1+t*bw, c+1+(t+1)*bw)``, the same ``(n, T, bw)`` / ``(n, T)``
layout as the JAX package's ``ChaseResult``, so results convert 1:1.  Within
one sweep the windows are disjoint, so :func:`apply_chase_q` applies a whole
sweep as one batched rank-1 update.

Here live the data layout and the plain references: the chase itself runs
in :mod:`.chase` (kernel B3), the back-transforms in :mod:`.wf_bt` (B4) and
:mod:`.backtransform` (B5); :func:`apply_chase_q_blocked` is the WY-grouped
back-transform (``EK_BACKTRANSFORM=blocked``) and the model of B5's block
order.  The sequential chase is not ported: the tests hold the wavefront
chase against the JAX package's.  The mesh paths
(``band_to_tridiag_chunked``, ``apply_chase_q_blocked_sharded``) and the
XLA wavefront schedules are not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ChaseResult(NamedTuple):
    d: torch.Tensor     # (n,)   tridiagonal diagonal
    e: torch.Tensor     # (n-1,) subdiagonal
    HV: torch.Tensor    # (n, T, bw) chase reflectors per (sweep, position)
    HT: torch.Tensor    # (n, T)     chase taus
    bw: int


def _house_pivot0(x: torch.Tensor):
    """Householder with pivot at x[..., 0], eliminating x[..., 1:]; batched
    over leading dimensions.  A zero tail gives v = 0 and tau = 0."""
    tail = x[..., 1:]
    sigma = (tail * tail).sum(-1)
    zero_tail = sigma == 0
    alpha = x[..., 0]
    sgn = torch.where(alpha >= 0, 1.0, -1.0).to(x.dtype)
    beta = torch.where(zero_tail, alpha,
                       -sgn * torch.sqrt(alpha * alpha + sigma))
    denom = torch.where(zero_tail, 1.0, alpha - beta).to(x.dtype)
    live = torch.logical_not(zero_tail).to(x.dtype)
    v = torch.cat([live[..., None], tail / denom[..., None]
                   * live[..., None]], dim=-1)
    tau = live * torch.where(zero_tail, 0.0,
                             (beta - alpha) / torch.where(beta == 0, 1.0,
                                                          beta))
    return v, tau


def _to_banded(band: torch.Tensor, b: int) -> torch.Tensor:
    """Lower-half banded storage of a dense symmetric band matrix: ``wb[i,
    q] = band[i, i + q - 2b]`` (zero outside the matrix), q in [0, 2b], all
    the wavefront chase stores (the JAX package's 4b+1 diagonals, cut to
    the lower half).  A plain index gather."""
    n = band.shape[0]
    W = 2 * b + 1
    rows = torch.arange(n, device=band.device)[:, None]
    cols = rows + torch.arange(W, device=band.device)[None, :] - 2 * b
    valid = (cols >= 0) & (cols < n)
    wb = band[rows, cols.clamp(0, n - 1)]
    return torch.where(valid, wb, torch.zeros((), dtype=band.dtype,
                                              device=band.device))


def trivial_chase(band: torch.Tensor, bw: int) -> ChaseResult:
    """The chase of n <= 2 or bw <= 1: the band is already tridiagonal."""
    n = band.shape[0]
    e = torch.diagonal(band, -1) if n > 1 else band.new_zeros(0)
    return ChaseResult(torch.diagonal(band).clone(), e.clone(),
                       band.new_zeros((n, 1, max(bw, 1))),
                       band.new_zeros((n, 1)), bw)


def apply_chase_q(res: ChaseResult, z: torch.Tensor) -> torch.Tensor:
    """``z <- Q2 z`` with Q2 the stage-2 chase transform: sweeps newest
    first, each as one batched rank-1 update of its T disjoint windows.
    Kernel B5's plain version.  Returns a new tensor."""
    n, k = z.shape
    T, b = res.HV.shape[1], res.HV.shape[2]
    if n <= 2 or b <= 1 or res.HV.shape[0] < n:
        return z.clone()
    zp = torch.zeros((n + (T + 2) * b, k), dtype=z.dtype, device=z.device)
    zp[:n] = z
    for c in reversed(range(n - 2)):
        v = res.HV[c]                                   # (T, b)
        tau = res.HT[c]                                 # (T,)
        zwin = zp[c + 1:c + 1 + T * b].view(T, b, k)
        coef = torch.einsum("tb,tbk->tk", v, zwin) * tau[:, None]
        zwin -= v[:, :, None] * coef[:, None, :]
    return zp[:n].clone()


def _wy_embed(hv_desc: torch.Tensor, g: int, b: int, L: int) -> torch.Tensor:
    """Shifted-diagonal embedding ``Y[..., r, j] = hv_desc[..., j,
    r - (g-1) + j]`` (zero where that index leaves [0, b)): the (L, g) WY
    block of g consecutive sweeps' reflectors at one band position, newest
    sweep (applied first) in column 0.  A plain index gather (the JAX
    package's flat-stride reshape is a TPU anti-gather device)."""
    dev = hv_desc.device
    r = torch.arange(L, device=dev)[:, None]
    j = torch.arange(g, device=dev)[None, :]
    q = r - (g - 1) + j
    valid = (q >= 0) & (q < b)
    flat = hv_desc.reshape(*hv_desc.shape[:-2], g * b)
    y = flat[..., (j * b + q.clamp(0, b - 1))]
    return torch.where(valid, y, torch.zeros((), dtype=y.dtype, device=dev))


def apply_chase_q_blocked(res: ChaseResult, z: torch.Tensor,
                          group: int = 0) -> torch.Tensor:
    """``z <- Q2 z`` with g consecutive sweeps WY-grouped (ELPA2's trick).

    At band position t the reflectors of g consecutive sweeps live in a
    (b+g-1)-row window, shifted one row per sweep.  Groups go newest
    first, positions in ascending t inside a group and sweeps newest first
    inside a window: that keeps the relative order of every overlapping
    reflector pair, so the product is exactly Q2 (the proof is in the JAX
    module).  Per window the reversed product is applied in compact form,
    ``P = I - Y M^{-1} Y^T`` with ``M = diag(1/tau) + tril(Y^T Y, -1)``.

    ``group`` 0 means 32, the JAX package's value off the TPU; g > b would
    make windows two positions apart overlap, so g is clamped to b.  The
    order kernel B5 (:mod:`.backtransform`) applies its blocks in.  Returns
    a new tensor."""
    n, k = z.shape
    T, b = res.HV.shape[1], res.HV.shape[2]
    if n <= 2 or b <= 1 or res.HV.shape[0] < n:
        return z.clone()
    g = min(group if group > 0 else 32, b)
    nsweeps = n - 2
    n_groups = -(-nsweeps // g)
    L = b + g - 1
    # pad the sweep axis in front so the oldest group's slice start is
    # always valid (zero reflectors are identities)
    HVp = torch.cat([res.HV.new_zeros((g, T, b)), res.HV[:n]])
    HTp = torch.cat([res.HT.new_zeros((g, T)), res.HT[:n]])
    top = g + 1
    zp = z.new_zeros((n + top + (T + 2) * b + g, k))
    zp[top:top + n] = z
    for s in range(n_groups * T):
        G, t = divmod(s, T)
        c0 = nsweeps - 1 - G * g
        # sweeps c0-g+1 .. c0 at position t, newest (c0) first
        hv_desc = HVp[c0 + 1:c0 + 1 + g, t].flip(0)
        ht_desc = HTp[c0 + 1:c0 + 1 + g, t].flip(0)
        Y = _wy_embed(hv_desc, g, b, L)                       # (L, g)
        tau_safe = torch.where(ht_desc == 0, 1.0, ht_desc)
        M = torch.tril(Y.T @ Y, -1) + torch.diag(1.0 / tau_safe)
        row0 = c0 - g + 2 + t * b + top
        zw = zp[row0:row0 + L]
        w2 = torch.linalg.solve_triangular(M, Y.T @ zw, upper=False)
        zw -= Y @ w2
    return zp[top:top + n].clone()


def group_stores(res: ChaseResult, n: int, b: int, g: int):
    """Group-major band-position reflector stores.

    Returns ``(X, Xt)`` with ``X[G, t]`` the (g*b,)-flat reflector block of
    group ``G`` (sweeps ``c0-g+1 .. c0``, ``c0 = n-3-G*g``, newest sweep
    first) at band position ``t``, and ``Xt[G, t]`` the matching (g,)
    taus.  The last group's missing sweeps are zero reflectors with
    tau = 0 (exact identities).
    """
    T = res.HV.shape[1]
    nsweeps = n - 2
    nG = -(-nsweeps // g)
    padG = nG * g - nsweeps
    hv = torch.cat([res.HV.new_zeros((padG, T, b)), res.HV[:nsweeps]])
    ht = torch.cat([res.HT.new_zeros((padG, T)), res.HT[:nsweeps]])
    # padded sweep row nG*g - (G+1)*g + i holds group G's (g-1-i)-th
    # newest sweep: flip both the group axis and the sweep axis
    X = hv.view(nG, g, T, b).flip(0, 1).permute(0, 2, 1, 3).reshape(
        nG, T, g * b)
    Xt = ht.view(nG, g, T).flip(0, 1).permute(0, 2, 1).reshape(nG, T, g)
    return X, Xt
