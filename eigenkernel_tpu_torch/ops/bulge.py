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
chase against the JAX package's.  On a process grid every rank runs the
chase on the replicated banded state in sweep ranges
(``chase.band_to_tridiag_chunked``, ``EK_CHASE_CHUNKS``); :func:`keep_own_groups`
keeps a rank's own WY groups of each finished range (the JAX package's
``_shard_chase_store`` applied per chunk) and
:func:`apply_chase_q_blocked_sharded` broadcasts them in turn.  The XLA
wavefront schedules are not ported.
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


def _group_size(group: int, b: int) -> int:
    """g of the WY-grouped back-transform: ``group`` (0 for 32, the JAX
    package's value off the TPU), clamped to b (g > b would make windows
    two positions apart overlap)."""
    return min(group if group > 0 else 32, b)


class _Frame(NamedTuple):
    zp: torch.Tensor    # z with zero rows around it
    top: int            # z's first row in zp
    n: int
    T: int
    b: int
    g: int


def _frame(z: torch.Tensor, T: int, b: int, g: int) -> _Frame:
    """z in a frame of zero rows: g + 1 above (the oldest group's windows
    start there) and b + g - 1 below (a window that starts inside z).
    Rows past z stay zero (the reflectors vanish there), so a window that
    starts past z is the identity and is skipped."""
    n = z.shape[0]
    top = g + 1
    zp = z.new_zeros((top + n + b + g - 1, z.shape[1]))
    zp[top:top + n] = z
    return _Frame(zp, top, n, T, b, g)


def _apply_group(fr: _Frame, G: int, hv_desc: torch.Tensor,
                 ht_desc: torch.Tensor) -> None:
    """Group ``G``'s sweeps ``c0-g+1 .. c0`` (c0 = n-3-G*g), given newest
    first as ``hv_desc`` (g, T, b) and ``ht_desc`` (g, T), applied to the
    frame at every band position in ascending t."""
    g, b = fr.g, fr.b
    L = b + g - 1
    c0 = fr.n - 3 - G * g
    for t in range(fr.T):
        row0 = c0 - g + 2 + t * b + fr.top
        if row0 >= fr.top + fr.n:
            break
        Y = _wy_embed(hv_desc[:, t], g, b, L)                 # (L, g)
        ht = ht_desc[:, t]
        tau_safe = torch.where(ht == 0, 1.0, ht)
        M = torch.tril(Y.T @ Y, -1) + torch.diag(1.0 / tau_safe)
        zw = fr.zp[row0:row0 + L]
        w2 = torch.linalg.solve_triangular(M, Y.T @ zw, upper=False)
        zw -= Y @ w2


def _group_slab(HV: torch.Tensor, HT: torch.Tensor, n: int, g: int, G: int,
                c_base: int = 0):
    """Group ``G``'s reflectors newest first, (g, T, b) and (g, T), from a
    store whose row 0 is sweep ``c_base``; sweeps before 0 are zero
    reflectors (exact identities)."""
    c0 = n - 3 - G * g
    lo = c0 - g + 1
    hv = HV[max(lo, 0) - c_base:c0 + 1 - c_base]
    ht = HT[max(lo, 0) - c_base:c0 + 1 - c_base]
    if lo < 0:
        hv = torch.cat([hv.new_zeros((-lo,) + tuple(hv.shape[1:])), hv])
        ht = torch.cat([ht.new_zeros((-lo,) + tuple(ht.shape[1:])), ht])
    return hv.flip(0), ht.flip(0)


def n_chase_groups(n: int, g: int) -> int:
    """The WY groups of g sweeps of a chase of n rows (n - 2 sweeps)."""
    return -(-(n - 2) // g)


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
    g = _group_size(group, b)
    fr = _frame(z, T, b, g)
    for G in range(n_chase_groups(n, g)):
        _apply_group(fr, G, *_group_slab(res.HV, res.HT, n, g, G))
    return fr.zp[fr.top:fr.top + n].clone()


class GridChaseStore(NamedTuple):
    """The chase reflectors on a process grid, sweep-sharded: WY group G
    of g sweeps (newest first, as :func:`apply_chase_q_blocked` takes
    them) lives on rank G mod P alone, as ``mine[G]`` = (g, T, b + 1), the
    taus in the last column."""

    g: int
    n_groups: int
    T: int
    b: int
    mine: dict


def keep_own_groups(store: GridChaseStore, n: int, grid):
    """The ``keep`` of a grid's chunked chase
    (``chase.band_to_tridiag_chunked``, its ranges cut at the edges of
    ``store``'s groups): from each finished range (its first sweep
    ``c_lo``, its (sweeps, T, b) and (sweeps, T) reflectors) put this
    rank's WY groups into ``store.mine`` and drop the rest (the JAX
    package's ``_shard_chase_store``, ``ops/bulge.py:138-158``, applied
    per chunk as ``band_to_tridiag_chunked`` does, ``:615-680``)."""
    g = store.g

    def keep(c_lo: int, hv: torch.Tensor, ht: torch.Tensor) -> None:
        c_hi = c_lo + hv.shape[0] - 1
        for G in range(grid.rank, store.n_groups, grid.size):
            c0 = n - 3 - G * g
            if c_lo <= c0 <= c_hi:
                if max(c0 - g + 1, 0) < c_lo:
                    raise ValueError(f"sweep range [{c_lo}, {c_hi}] cuts "
                                     f"WY group {G}")
                s, t = _group_slab(hv, ht, n, g, G, c_lo)
                store.mine[G] = torch.cat([s, t[..., None]], dim=2)
    return keep


def apply_chase_q_blocked_sharded(res: ChaseResult, z: torch.Tensor,
                                  grid) -> torch.Tensor:
    """:func:`apply_chase_q_blocked` on a grid (JAX
    ``apply_chase_q_blocked_sharded``, ``ops/bulge.py:683-781``): ``z`` is
    this rank's own columns, whole rows, so every window update is local;
    each group's (g, T, b + 1) slab is broadcast once by its rank, newest
    group first, and applied.  A rank holds its own groups and one slab
    more."""
    from eigenkernel_tpu_torch.parallel import mesh as pm

    st = res.HV
    n = z.shape[0]
    if n <= 2 or st.b <= 1:
        return z.clone()
    fr = _frame(z, st.T, st.b, st.g)
    for G in range(st.n_groups):
        slab = st.mine.get(G)
        if slab is None:
            slab = z.new_empty((st.g, st.T, st.b + 1))
        pm.broadcast(slab, grid, G % grid.size)
        _apply_group(fr, G, slab[..., :st.b], slab[..., st.b])
    return fr.zp[fr.top:fr.top + n].clone()


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
