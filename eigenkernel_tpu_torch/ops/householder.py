"""Blocked Householder tridiagonalization + compact-WY back-transform.

Counterpart of ``eigenkernel_tpu/ops/householder.py``:

* ``tridiagonalize`` <- ``pdsytrd``: ``T = Q^T A Q`` with
  ``Q = H_0 H_1 ... H_{n-2}``, lower variant.
* ``apply_q``        <- ``pdormtr``: ``z <- Q z``.

``tridiagonalize`` is the plain LAPACK dsytrd/dlatrd: each panel of ``b``
columns runs its Householder steps with the panel's pending updates kept
as ``V`` and ``W = tau (A v - corrections)`` columns, then the trailing
block, which shrinks panel by panel, takes one rank-2b update
``A22 -= [V W] [W V]^T``.  The last panel may be narrower than ``b``.
Each panel's steps are :func:`tridiag_panel`: on a CUDA tensor one launch
of kernel D4 (``csrc/panel_trd.cu``, which reads only the trailing
block's lower triangle; ``LAUNCHES`` counts them, one a panel), on a CPU
tensor the plain :func:`tridiag_panel_plain`, D4's model.  (The JAX
package's masked full-size panels and bucketed recursion exist because
every XLA shape compiles separately; eager PyTorch has no such cost.)

``apply_q`` applies groups of panels in reverse with the compact-WY
identity ``H_s ... H_{s+g-1} = I - V T V^T``,
``T = inv(diag(1/tau) + striu(V^T V))``, so the back-transform is GEMMs plus
one small triangular solve per group.

On a process grid (``mesh=``, the matrix a :class:`DistMatrix` of plain
2D blocks, ``parallel/mesh.py``) the same loop is ScaLAPACK's pdlatrd:
each panel's columns are gathered whole onto every rank by one
``all_reduce``, and each column's ``A22 v`` is the local block product,
put in this rank's rows of a zeroed column and summed over the grid by
one ``all_reduce``.  That one call is ScaLAPACK's reduction along the
process row and gather along the process column fused: with gathers built
from ``all_reduce``, the two would move this rank's nr rows and then the
whole column, two calls a column, where the fused call moves the column
once.  The panel's V and W, d, e and taus are formed identically on every
rank, and the rank-2b trailing update is local to each block.  The
reflectors are kept by WY group (:func:`wy_groups`), group i on rank
i mod P only, so a rank holds 1/P of V; ``apply_q`` on a rank's own
columns of z broadcasts each group from its rank in turn
(:class:`GridReflectors`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from eigenkernel_tpu_torch.obs import events
from eigenkernel_tpu_torch.ops import build
from eigenkernel_tpu_torch.parallel import mesh as pm


LAUNCHES = 0        # launches of D4 by tridiag_panel (CPU tensors add none)

UNIT_ROWS = 16      # csrc/panel_trd.cu kHigh: rows of a unit of A v
STRIP_BYTES = 2048  # csrc/panel_trd.cu kWide * itemsize: a strip's width
UNITS_MIN = 4       # a D4 CTA takes at least this many units where it can
MAX_WIDTH = 256     # csrc/panel_trd.cu kMaxB: the widest panel

_FN = {torch.float64: "ek_panel_trd_f64", torch.float32: "ek_panel_trd_f32"}


class TridiagResult(NamedTuple):
    d: torch.Tensor     # (n,)   diagonal of T
    e: torch.Tensor     # (n-1,) subdiagonal of T
    V: torch.Tensor     # (n, n) Householder vectors, column c = v_c (v[c+1]=1)
    #                     (a GridReflectors on a process grid)
    taus: torch.Tensor  # (n,)   reflector coefficients (0 => identity)


class GridReflectors(NamedTuple):
    """V on a process grid: WY group i (columns ``groups[i]``) is held by
    rank i mod P alone, as ``mine[i]`` = ``V[s:, s:s + w]``."""

    groups: list        # [(s, w)] of :func:`wy_groups`
    mine: dict          # group index -> this rank's (n - s, w) block


def wy_groups(n: int, block: int, parts: int = 1) -> list:
    """The (start, width) of the compact-WY groups of ``apply_wy``: panels
    of ``block`` columns, ``512 // block`` of them a group (512 columns,
    as the JAX package's default ``EK_ORMTR_GROUP``), and no more than
    1/``parts`` of the panels (so that on a grid of that many ranks a
    group, which one rank holds, is not the whole of V)."""
    b = max(1, min(block, n))
    panels = -(-n // b)
    gb = max(1, min(512 // b, -(-panels // parts))) * b
    return [(s, min(gb, n - s)) for s in range(0, n, gb)]


def _householder(x: torch.Tensor, alpha: torch.Tensor):
    """Reflector ``(I - tau v v^T) [alpha; x] = [beta; 0]`` with
    ``v = [head; tail]``.

    ``head`` is 1, or 0 when ``x`` is zero (then tau = 0 and beta = alpha:
    the identity).  ``beta = -sign(alpha) ||[alpha; x]||`` with
    sign(0) = +1, the JAX package's convention.  All on the device: no
    host synchronization.
    """
    sigma = (x * x).sum()
    zero_tail = sigma == 0
    sgn = torch.where(alpha >= 0, 1.0, -1.0).to(alpha.dtype)
    mu = torch.sqrt(alpha * alpha + sigma)
    beta = torch.where(zero_tail, alpha, -sgn * mu)
    denom = torch.where(zero_tail, 1.0, alpha - beta)
    tail = x / denom
    tau = torch.where(zero_tail, 0.0,
                      (beta - alpha) / torch.where(beta == 0, 1.0, beta))
    head = torch.logical_not(zero_tail).to(alpha.dtype)
    return head, tail, tau, beta


def tridiagonalize(a, block: int = 64,
                   mesh: Optional[pm.ProcessGrid] = None) -> TridiagResult:
    """Reduce symmetric ``a`` to tridiagonal ``T = Q^T A Q`` (pdsytrd
    analog).  ``a`` is not modified.  With ``mesh``, ``a`` is a
    :class:`~eigenkernel_tpu_torch.parallel.mesh.DistMatrix` on that grid
    and the result, of its padded dimension, is whole on every rank."""
    if mesh is not None:
        return _tridiagonalize_grid(a, block, mesh)
    n = a.shape[0]
    dtype, dev = a.dtype, a.device
    b = max(1, min(block, n))
    # row-major, whatever a's layout (the generalized reductions hand over
    # a transposed one): each panel's trailing block then has unit column
    # stride, as D4 reads it
    A = a.clone(memory_format=torch.contiguous_format)
    d = torch.zeros(n, dtype=dtype, device=dev)
    e = torch.zeros(max(n - 1, 0), dtype=dtype, device=dev)
    taus = torch.zeros(n, dtype=dtype, device=dev)
    V = torch.zeros((n, n), dtype=dtype, device=dev)
    for s in range(0, n, b):
        bw = min(b, n - s)
        As = A[s:, s:]                     # trailing block, a view of A
        with events.span("tridiagonalize:panel"):
            vw, wv = tridiag_panel(As, bw, d[s:s + bw], e[s:s + bw],
                                   taus[s:s + bw])
        with events.span("tridiagonalize:update"):
            if bw < n - s:
                As[bw:, bw:].addmm_(vw[bw:], wv[bw:].T, alpha=-1.0)
            V[s:, s:s + bw] = vw[:, :bw]
    return TridiagResult(d=d, e=e, V=V, taus=taus)


def tridiag_panel_plain(As: torch.Tensor, bw: int, d: torch.Tensor,
                        e: torch.Tensor, taus: torch.Tensor):
    """D4's model: the dlatrd steps of the first ``bw`` columns of the
    symmetric trailing block ``As`` (m, m; not modified), on any device.
    Writes ``d`` (bw), ``e`` (min(bw, m - 1)) and ``taus`` (bw) in place;
    the column j = m - 1, which closes the matrix, writes ``d[j]`` only.
    Returns ``(vw, wv)``, the (m, 2 bw) ``[V W]`` and ``[W V]`` of the
    rank-2b update: column j of V is v_j (zero above row j + 1) and of W
    is ``w_j = tau (A v - V (W^T v) - W (V^T v)) - (tau/2)(w^T v) v``."""
    m = As.shape[0]
    Vp = torch.zeros((m, bw), dtype=As.dtype, device=As.device)
    Wp = torch.zeros((m, bw), dtype=As.dtype, device=As.device)
    for j in range(bw):
        # column j with the panel's pending updates, rows j..m-1
        col = As[j:, j] - Vp[j:, :j] @ Wp[j, :j] - Wp[j:, :j] @ Vp[j, :j]
        d[j] = col[0]
        if j == m - 1:
            break
        head, tail, tau, beta = _householder(col[2:], col[1])
        e[j] = beta
        taus[j] = tau
        r = j + 1                          # pivot row; v vanishes above it
        v = torch.cat([head.reshape(1), tail])
        Vr, Wr = Vp[r:, :j], Wp[r:, :j]
        av = As[r:, r:] @ v - Vr @ (Wr.T @ v) - Wr @ (Vr.T @ v)
        w = tau * av
        w = w - (0.5 * tau * (w @ v)) * v
        Vp[r:, j] = v
        Wp[r:, j] = w
    return torch.cat([Vp, Wp], dim=1), torch.cat([Wp, Vp], dim=1)


def trd_units(m: int, itemsize: int):
    """``(strips, units)`` of D4's walk of an (m, m) block's lower
    triangle (``panel_trd.cu::strip_start``): strips of ``STRIP_BYTES``,
    each from the first unit of ``UNIT_ROWS`` rows the diagonal crosses
    down."""
    ratio = STRIP_BYTES // itemsize // UNIT_ROWS
    nu = -(-m // UNIT_ROWS)
    ns = -(-nu // ratio)
    return ns, ns * nu - ratio * ns * (ns - 1) // 2


def trd_plan(m: int, itemsize: int = 8, sms: int = 132) -> int:
    """CTAs of D4 on an (m, m) trailing block: one an SM, and no more than
    leave each at least ``UNITS_MIN`` units of the lower triangle (fewer
    CTAs keep a small panel's barriers cheap)."""
    return max(1, min(sms, -(-trd_units(m, itemsize)[1] // UNITS_MIN)))


def trd_scratch_words(m: int, bw: int, grid: int, itemsize: int = 8) -> int:
    """Words of D4's scratch (``panel_trd.cu::scratch_words``): a slot of
    ``UNIT_ROWS`` words a unit and of a strip's width a run, the column,
    w' and y (m each), and the CTAs' partial sums."""
    ns, units = trd_units(m, itemsize)
    return (UNIT_ROWS * units + STRIP_BYTES // itemsize * (ns + grid)
            + 3 * m + grid * (2 + 2 * bw))


def tridiag_panel(As: torch.Tensor, bw: int, d: torch.Tensor,
                  e: torch.Tensor, taus: torch.Tensor):
    """The dlatrd steps of the panel of ``bw`` columns of the trailing
    block ``As`` (m, m; not modified), as :func:`tridiag_panel_plain`
    returns and writes them.  A CUDA tensor launches D4 once, which reads
    only the lower triangle of ``As``; a CPU tensor runs
    :func:`tridiag_panel_plain`."""
    if As.dtype not in _FN:
        raise TypeError(f"tridiag_panel: dtype {As.dtype} not "
                        f"float32/float64")
    m = As.shape[0] if As.dim() == 2 else 0
    if As.dim() != 2 or As.shape[1] != m or not 1 <= bw <= m:
        raise ValueError(f"tridiag_panel: a square block and 1 <= bw <= m "
                         f"expected, got {tuple(As.shape)}, bw = {bw}")
    if As.device.type == "cpu":
        return tridiag_panel_plain(As, bw, d, e, taus)
    if As.device.type != "cuda":
        raise ValueError(f"tridiag_panel: unsupported device {As.device}")
    sms = torch.cuda.get_device_properties(As.device).multi_processor_count
    return _launch(As, bw, d, e, taus, trd_plan(m, As.element_size(), sms))


def _launch(As: torch.Tensor, bw: int, d: torch.Tensor, e: torch.Tensor,
            taus: torch.Tensor, grid: int):
    """D4 on the CUDA block ``As`` with ``grid`` CTAs; any grid that can be
    co-resident (the card tests and ``chip_smoke.py`` take others than
    :func:`trd_plan`'s)."""
    global LAUNCHES
    m = As.shape[0]
    if bw > MAX_WIDTH:
        raise build.KernelLaunchError(
            f"tridiag_panel: a panel of {bw} columns, more than "
            f"{MAX_WIDTH}")
    if As.stride(1) != 1:                 # tridiagonalize's blocks have it
        raise ValueError(f"tridiag_panel: a block of unit column stride "
                         f"expected, got strides {As.stride()}")
    for x, size in ((d, bw), (e, min(bw, m - 1)), (taus, bw)):
        if x.shape != (size,) or x.dtype != As.dtype or \
                x.device != As.device or (size > 1 and x.stride(0) != 1):
            raise ValueError(f"tridiag_panel: an output of {size} "
                             f"contiguous {As.dtype} on {As.device} "
                             f"expected, got {tuple(x.shape)}")
    ld = As.stride(0) if m > 1 else 1
    vec = As.data_ptr() % 16 == 0 and ld * As.element_size() % 16 == 0
    vt = torch.empty((3 * bw, m), dtype=As.dtype, device=As.device)
    scratch = torch.empty(trd_scratch_words(m, bw, grid, As.element_size()),
                          dtype=As.dtype, device=As.device)
    bar = torch.zeros(1, dtype=torch.int32, device=As.device)
    name = _FN[As.dtype]
    stream = torch.cuda.current_stream(As.device).cuda_stream
    status = getattr(build.library(), name)(
        As.data_ptr(), ld, m, bw, grid, int(vec), vt.data_ptr(),
        d.data_ptr(), e.data_ptr(), taus.data_ptr(), scratch.data_ptr(),
        bar.data_ptr(), stream)
    build.check(status, name)
    LAUNCHES += 1
    return vt[:2 * bw].T, vt[bw:].T


def _tridiagonalize_grid(a: pm.DistMatrix, block: int,
                         grid: pm.ProcessGrid) -> TridiagResult:
    """pdlatrd on plain 2D blocks: the loop of :func:`tridiagonalize` in
    global indices, with the trailing block read only through this rank's
    block ``A[r0:r0+nr, c0:c0+nc]``."""
    if a.grid is not grid:
        raise ValueError("tridiagonalize: the matrix is on another grid")
    A = a.local.clone()
    n, (nr, nc) = a.n_m, A.shape
    r0, c0 = a.row0, a.col0
    dtype, dev = A.dtype, A.device
    b = max(1, min(block, n))
    d = torch.zeros(n, dtype=dtype, device=dev)
    e = torch.zeros(max(n - 1, 0), dtype=dtype, device=dev)
    taus = torch.zeros(n, dtype=dtype, device=dev)
    groups = wy_groups(n, block)
    mine = {i: torch.zeros((n - gs, w), dtype=dtype, device=dev)
            for i, (gs, w) in enumerate(groups) if i % grid.size == grid.rank}
    gb = groups[0][1]                      # a multiple of the panel width

    def local(lo: int):
        """This block's rows and columns at global index >= lo, as local
        starts (nr / nc when none)."""
        return min(max(lo - r0, 0), nr), min(max(lo - c0, 0), nc)

    for s in range(0, n, b):
        bw = min(b, n - s)
        m = n - s
        with events.span("tridiagonalize:panel"):
            # the panel's columns, rows s..n-1, whole on every rank
            lr, lc = local(s)
            lc1 = min(max(s + bw - c0, 0), nc)
            panel = torch.zeros((m, bw), dtype=dtype, device=dev)
            if lr < nr and lc < lc1:
                panel[r0 + lr - s:r0 + nr - s, c0 + lc - s:c0 + lc1 - s] = \
                    A[lr:, lc:lc1]
            pm.all_reduce(panel, grid)
            Vp = torch.zeros((m, bw), dtype=dtype, device=dev)
            Wp = torch.zeros((m, bw), dtype=dtype, device=dev)
            for j in range(bw):
                c = s + j
                col = panel[j:, j] - Vp[j:, :j] @ Wp[j, :j] \
                    - Wp[j:, :j] @ Vp[j, :j]
                d[c] = col[0]
                if c == n - 1:
                    break
                head, tail, tau, beta = _householder(col[2:], col[1])
                e[c] = beta
                taus[c] = tau
                r = j + 1
                g = s + r                  # global index of v[0]
                v = torch.cat([head.reshape(1), tail])
                # A22 v: this block's rows and columns >= g in this rank's
                # rows of a zeroed column, summed over the grid (the
                # process-row reduction and the process-column gather in
                # one call)
                av = torch.zeros(n - g, dtype=dtype, device=dev)
                lr, lc = local(g)
                if lr < nr and lc < nc:
                    av[r0 + lr - g:r0 + nr - g] = \
                        A[lr:, lc:] @ v[c0 + lc - g:c0 + nc - g]
                pm.all_reduce(av, grid)
                Vr, Wr = Vp[r:, :j], Wp[r:, :j]
                av = av - Vr @ (Wr.T @ v) - Wr @ (Vr.T @ v)
                w = tau * av
                w = w - (0.5 * tau * (w @ v)) * v
                Vp[r:, j] = v
                Wp[r:, j] = w
        with events.span("tridiagonalize:update"):
            lr, lc = local(s + bw)
            if bw < m and lr < nr and lc < nc:
                vw = torch.cat([Vp, Wp], dim=1)
                wv = torch.cat([Wp, Vp], dim=1)
                A[lr:, lc:].addmm_(vw[r0 + lr - s:r0 + nr - s],
                                   wv[c0 + lc - s:c0 + nc - s].T, alpha=-1.0)
            if s // gb in mine:
                gs = groups[s // gb][0]
                mine[s // gb][s - gs:, s - gs:s - gs + bw] = Vp
    return TridiagResult(d=d, e=e, V=GridReflectors(groups, mine), taus=taus)


def wy_t_factor(v: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """Compact-WY T factor: ``H_1...H_b = I - V T V^T`` with T upper
    triangular, via ``T = inv(diag(1/tau) + striu(V^T V))``.

    taus of exactly 0 denote identity reflectors (their V column is zero);
    the safe diagonal keeps the small inverse well defined.
    """
    b = taus.shape[0]
    g = v.T @ v
    safe_diag = 1.0 / torch.where(taus == 0, 1.0, taus)
    m = torch.triu(g, diagonal=1) + torch.diag(safe_diag)
    eye = torch.eye(b, dtype=v.dtype, device=v.device)
    return torch.linalg.solve_triangular(m, eye, upper=True)


def apply_wy(V: torch.Tensor, taus: torch.Tensor, z: torch.Tensor,
             block: int = 64) -> torch.Tensor:
    """``H_0 H_1 ... z`` for reflectors stored as the columns of ``V``
    (column c zero above row c), each group of panels as one compact-WY
    product.

    The groups of :func:`wy_groups` (512 columns) are applied last to
    first, each as ``z -= V (T (V^T z))`` on the rows the group's
    reflectors touch: one pass over z per group instead of one per panel.
    Returns a new tensor; ``z`` is not modified.
    """
    z = z.clone()
    for s, w in reversed(wy_groups(V.shape[0], block)):
        v = V[s:, s:s + w]                 # rows above s are zero
        t = wy_t_factor(v, taus[s:s + w])
        zs = z[s:]
        zs -= v @ (t @ (v.T @ zs))
    return z


def apply_q(tri: TridiagResult, z: torch.Tensor, block: int = 64,
            mesh: Optional[pm.ProcessGrid] = None) -> torch.Tensor:
    """``Q z`` with Q from :func:`tridiagonalize` (pdormtr analog).  On a
    grid ``z`` is a rank's own columns, whole: each WY group is broadcast
    from the rank that holds it and applied to them, last to first."""
    with events.span("bt:band"):
        if mesh is None:
            return apply_wy(tri.V, tri.taus, z, block)
        return apply_wy_grid(tri.V, tri.taus, z, mesh)


def apply_wy_grid(refl: GridReflectors, taus: torch.Tensor, z: torch.Tensor,
                  mesh: pm.ProcessGrid) -> torch.Tensor:
    """:func:`apply_wy` on a grid: ``z`` a rank's own columns, whole; each
    WY group broadcast from the rank that holds it, last to first."""
    z = z.clone()
    n = z.shape[0]
    for i, (s, w) in reversed(list(enumerate(refl.groups))):
        v = refl.mine.get(i)
        if v is None:
            v = torch.empty((n - s, w), dtype=z.dtype, device=z.device)
        pm.broadcast(v, mesh, i % mesh.size)
        t = wy_t_factor(v, taus[s:s + w])
        zs = z[s:]
        zs -= v @ (t @ (v.T @ zs))
    return z


def tridiag_matrix(d: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Dense tridiagonal matrix from (d, e) — for tests and small n."""
    t = torch.diag(d)
    if d.shape[0] > 1:
        t = t + torch.diag(e, 1) + torch.diag(e, -1)
    return t
