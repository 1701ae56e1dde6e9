"""The process grid (the BLACS grid) on ``torch.distributed``, and the
collective layer every sharded step is written on.

Counterpart of ``eigenkernel_tpu/parallel/mesh.py``:

* ``layout_grid``   <- ``layout_grid`` (``mesh.py:40-49``, a copy):
  near-square ``P = R x C`` with ``R <= C``.
* ``make_mesh``     <- ``make_mesh`` (``mesh.py:52-62``): a
  :class:`ProcessGrid` over the ranks of the initialized process group,
  rank ``pr * C + pc`` at grid position ``(pr, pc)``, as the JAX package
  reshapes its device list.
* ``padded_dim``    <- ``padded_dim`` (``mesh.py:92-98``): a multiple of
  lcm(R, C) only; every op of this package takes any n, so there is no
  panel multiple.
* ``distribute`` / ``distribute_coo`` <- ``mesh.py:101-153``: each rank
  holds only its plain (n_m / R, n_m / C) block, as the JAX layout does
  (``mesh.py:18-24``), densified from the broadcast triplets with both
  (i, j) and (j, i) set per entry; no rank builds the dense matrix.
* ``gather``        <- ``mesh.py:156-159``.
* ``print_grid_mapping`` <- ``mesh.py:162-172``, the same text.
* ``matmul``, ``times_tall`` and ``transpose``: the sharded products that
  GSPMD partitions for the JAX package (``ops/blocked.py:39-43``'s
  ``_wsc`` products), written out: SUMMA on plain blocks (each k-panel
  broadcast along the process rows and columns), a block times a
  replicated tall operand summed into one zero-padded ``all_reduce``, and
  a transpose by per-rank broadcasts.
* ``times_columns`` (a block matrix times each rank's own columns),
  ``submatrix`` (a principal block onto a DistMatrix of its own) and
  ``swap`` (a neighbouring rank's tensor, over a group of the two): the
  products and moves of the ``jacobi``, ``qdwh`` and mixed grid paths.

Every sharded step is written on ``all_reduce`` and ``broadcast`` alone:
torch's backend table documents gloo as taking CUDA tensors for those two
only, so the same code runs under NCCL, gloo on CPU tensors and gloo on
CUDA tensors (several ranks on one card).  A gather of small results is
an ``all_reduce`` of a zeroed buffer in which each rank fills its own slot
(:func:`gather_slots`); a product that needs every rank's share of a
large operand takes the shares one at a time, each rank's broadcast in
turn (:func:`rank_shares`), so no rank ever holds more than its own share
and one other.  Nothing here moves a tensor to the host for a backend.
Each grid counts its collectives and their bytes
(:class:`CollectiveStats`), and each collective is a span ``grid:<op>``
of the active event log (``obs/events.py``), which ``--profile`` joins
with the device's work (NCCL's kernels included).
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from eigenkernel_tpu_torch.obs import events

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN, "prod": dist.ReduceOp.PRODUCT}


def layout_grid(n_procs: int) -> tuple[int, int]:
    """Near-square factorization ``n = r * c`` with ``r <= c``.

    Mirrors layout_procs (processes.f90:56-65): r is the largest divisor of
    ``n_procs`` not exceeding sqrt(n_procs).
    """
    r = int(math.isqrt(n_procs))
    while r > 1 and n_procs % r != 0:
        r -= 1
    return r, n_procs // r


@dataclass
class CollectiveStats:
    """Collectives a grid made and the bytes they moved."""

    calls: int = 0
    bytes: int = 0


@dataclass(eq=False)
class ProcessGrid:
    """An R x C grid of ranks: this rank's place in it, its row and column
    subgroups (None outside a process group, e.g. for
    :func:`padded_dim`), the device its blocks live on, and the counts of
    its collectives."""

    R: int
    C: int
    rank: int
    device: torch.device
    row_group: Any = None
    col_group: Any = None
    stats: CollectiveStats = field(default_factory=CollectiveStats)
    neighbour_groups: Any = None    # make_neighbour_groups: {r, r + 1}

    @property
    def size(self) -> int:
        return self.R * self.C

    @property
    def pr(self) -> int:
        return self.rank // self.C

    @property
    def pc(self) -> int:
        return self.rank % self.C


def make_mesh(shape: Optional[tuple[int, int]] = None,
              device: Any = None) -> ProcessGrid:
    """The R x C grid over the ranks of the initialized process group
    (setup_distribution analog).  ``shape`` defaults to
    :func:`layout_grid` of the world size; ``device`` to
    ``cuda:<rank mod cards>``.  Every rank must call it, in the same
    order as any other group creation."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "parallel.multihost.init_distributed first")
    size, rank = dist.get_world_size(), dist.get_rank()
    r, c = shape if shape is not None else layout_grid(size)
    if r * c != size:
        raise ValueError(f"mesh shape {(r, c)} does not match the "
                         f"{size} processes")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass "
                               "device='cpu' to run the grid on the CPU")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    rows = [dist.new_group([i * c + j for j in range(c)]) for i in range(r)]
    cols = [dist.new_group([i * c + j for i in range(r)]) for j in range(c)]
    return ProcessGrid(R=r, C=c, rank=rank, device=torch.device(device),
                       row_group=rows[rank // c], col_group=cols[rank % c])


def single_device_mesh(device: Any = None) -> ProcessGrid:
    """A 1 x 1 grid (it needs a one-rank process group, as any grid)."""
    return make_mesh((1, 1), device)


def pad_to(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def padded_dim(n: int, grid: ProcessGrid) -> int:
    """The matrix dimension each grid axis splits into equal blocks."""
    return pad_to(n, math.lcm(grid.R, grid.C))


def share(k: int, parts: int, index: int) -> tuple[int, int]:
    """``[lo, hi)``: part ``index`` of ``k`` items cut into ``parts``
    contiguous runs whose lengths differ by at most one."""
    return index * k // parts, (index + 1) * k // parts


# ---------------------------------------------------------------------------
# the collective layer
# ---------------------------------------------------------------------------

def _group(grid: ProcessGrid, over: str):
    return {"world": None, "row": grid.row_group,
            "col": grid.col_group}[over]


def all_reduce(x: torch.Tensor, grid: ProcessGrid, op: str = "sum",
               over: str = "world") -> torch.Tensor:
    """In-place ``all_reduce`` of ``x`` over the grid ("world"), this
    rank's process row ("row") or process column ("col"); returns x."""
    with events.span("grid:all_reduce"):
        dist.all_reduce(x, op=_OPS[op], group=_group(grid, over))
    grid.stats.calls += 1
    grid.stats.bytes += x.numel() * x.element_size()
    return x


def broadcast(x: torch.Tensor, grid: ProcessGrid, src: int,
              over: str = "world") -> torch.Tensor:
    """In-place ``broadcast`` of ``x`` from grid rank ``src`` to the grid
    ("world"), or to ``src``'s and this rank's process row ("row") or
    column ("col"); returns x."""
    with events.span("grid:broadcast"):
        dist.broadcast(x, src, group=_group(grid, over))
    grid.stats.calls += 1
    grid.stats.bytes += x.numel() * x.element_size()
    return x


def make_neighbour_groups(grid: ProcessGrid) -> None:
    """Make the groups of ranks {r, r + 1} that :func:`swap` uses, once a
    grid; every rank must call it at the same point."""
    if grid.neighbour_groups is None:
        grid.neighbour_groups = [dist.new_group([r, r + 1])
                                 for r in range(grid.size - 1)]


def swap(part: torch.Tensor, grid: ProcessGrid, peer: int) -> torch.Tensor:
    """``peer``'s ``part`` (the same shape as this rank's), for a peer
    next to this rank (``|peer - rank| == 1``): one ``all_reduce`` over
    the two of them (:func:`make_neighbour_groups`) of a zeroed pair of
    slots, each filling its own."""
    lo = min(grid.rank, peer)
    if max(grid.rank, peer) != lo + 1:
        raise ValueError(f"swap: ranks {grid.rank} and {peer} are not "
                         f"neighbours")
    group = grid.neighbour_groups[lo]
    buf = torch.zeros((2,) + tuple(part.shape), dtype=part.dtype,
                      device=part.device)
    buf[int(grid.rank != lo)] = part
    with events.span("grid:swap"):
        dist.all_reduce(buf, group=group)
    grid.stats.calls += 1
    grid.stats.bytes += buf.numel() * buf.element_size()
    return buf[int(peer != lo)]


def barrier(grid: ProcessGrid) -> None:
    """Wait until every rank got here, by a one-element ``all_reduce``."""
    all_reduce(torch.zeros(1, device=grid.device), grid)


def gather_slots(part: torch.Tensor, index, shape, grid: ProcessGrid,
                 over: str = "world") -> torch.Tensor:
    """A zeroed ``shape`` buffer with ``part`` at ``buf[index]`` on this
    rank, summed over the ranks: the gather of slots that the ranks fill
    each once (a slot filled by none stays 0)."""
    buf = torch.zeros(shape, dtype=part.dtype, device=part.device)
    buf[index] = part
    return all_reduce(buf, grid, over=over)


def rank_shares(part: torch.Tensor, grid: ProcessGrid, shapes=None):
    """Yield ``(q, part_q)`` for every grid rank q in turn: rank q's
    ``part``, broadcast from it, so a rank holds its own share and one
    other at a time.  ``shapes`` are the ranks' shapes; by default the
    shares differ in their last dimension only, which is gathered."""
    if shapes is None:
        widths = gather_slots(
            torch.tensor([part.shape[-1]], device=part.device), grid.rank,
            (grid.size,), grid)
        shapes = [tuple(part.shape[:-1]) + (int(w),) for w in widths]
    for q, shape in enumerate(shapes):
        if q == grid.rank:
            buf = part.contiguous()
        else:
            buf = torch.empty(shape, dtype=part.dtype, device=part.device)
        if buf.numel():
            broadcast(buf, grid, q)
        yield q, buf


# ---------------------------------------------------------------------------
# matrices and eigenvectors on the grid
# ---------------------------------------------------------------------------

class ColumnShares(NamedTuple):
    """Eigenpairs on a grid: ``values`` (k,) ascending on every rank;
    ``vectors`` this rank's columns, whole (n rows); ``cols`` their places
    in ``values`` (int64, any order; each place on one rank)."""

    values: torch.Tensor
    vectors: torch.Tensor
    cols: torch.Tensor


def contiguous_shares(values: torch.Tensor, vectors: torch.Tensor,
                      grid: ProcessGrid) -> ColumnShares:
    """This rank's run of the columns of ``vectors`` (n, k), which every
    rank holds whole."""
    lo, hi = share(vectors.shape[1], grid.size, grid.rank)
    return ColumnShares(values, vectors[:, lo:hi], torch.arange(
        lo, hi, device=vectors.device))


@dataclass
class DistMatrix:
    """A square matrix on the grid (symmetric, or a triangular factor):
    this rank's block ``A[pr*nr:(pr+1)*nr, pc*nc:(pc+1)*nc]`` of the
    zero-padded (n_m, n_m) matrix, ``n`` its logical dimension."""

    local: torch.Tensor
    n: int
    grid: ProcessGrid

    @property
    def n_m(self) -> int:
        return self.local.shape[0] * self.grid.R

    @property
    def row0(self) -> int:
        return self.grid.pr * self.local.shape[0]

    @property
    def col0(self) -> int:
        return self.grid.pc * self.local.shape[1]

    def with_local(self, local: torch.Tensor) -> "DistMatrix":
        return DistMatrix(local=local, n=self.n, grid=self.grid)

    def rows(self, lo: int, hi: int) -> tuple[int, int]:
        """Global rows [lo, hi) as a local run [a, b) of this block."""
        return span(lo, hi, self.row0, self.local.shape[0])

    def cols(self, lo: int, hi: int) -> tuple[int, int]:
        """Global columns [lo, hi) as a local run [a, b) of this block."""
        return span(lo, hi, self.col0, self.local.shape[1])


def span(lo: int, hi: int, start: int, size: int) -> tuple[int, int]:
    """The global run [lo, hi) as local indices [a, b) of a block that
    starts at ``start`` and holds ``size`` (a == b when they miss)."""
    a = min(max(lo - start, 0), size)
    return a, max(a, min(max(hi - start, 0), size))


def _block_bounds(n_m: int, grid: ProcessGrid):
    nr, nc = n_m // grid.R, n_m // grid.C
    return grid.pr * nr, (grid.pr + 1) * nr, grid.pc * nc, (grid.pc + 1) * nc


def distribute(a: Any, grid: ProcessGrid, dtype: torch.dtype,
               n: Optional[int] = None) -> DistMatrix:
    """This rank's block of the dense symmetric ``a`` (numpy array or
    tensor, every rank holding the same), zero-padded to
    :func:`padded_dim`; ``n`` trims a zero-padded ``a`` to its logical
    dimension."""
    n = int(a.shape[0]) if n is None else int(n)
    n_m = padded_dim(n, grid)
    r0, r1, c0, c1 = _block_bounds(n_m, grid)
    src = torch.as_tensor(a)
    blk = torch.zeros((r1 - r0, c1 - c0), dtype=dtype, device=grid.device)
    rr, cc = min(r1, n), min(c1, n)
    if rr > r0 and cc > c0:
        blk[:rr - r0, :cc - c0] = src[r0:rr, c0:cc].to(
            device=grid.device, dtype=dtype)
    return DistMatrix(local=blk, n=n, grid=grid)


def distribute_coo(coo, grid: ProcessGrid, dtype: torch.dtype) -> DistMatrix:
    """Shard-local densify of a COO matrix (the triplets already on every
    rank, e.g. from :func:`multihost.bcast_coo`): this rank builds only
    its own block, from the entries and their mirror images that fall in
    it (distribute_matrix.f90:401-422, 415-417)."""
    n = coo.size
    n_m = padded_dim(n, grid)
    r0, r1, c0, c1 = _block_bounds(n_m, grid)
    off = coo.rows != coo.cols
    r_all = np.concatenate([coo.rows, coo.cols[off]])
    c_all = np.concatenate([coo.cols, coo.rows[off]])
    v_all = np.concatenate([coo.values, coo.values[off]])
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    blk = np.zeros((r1 - r0, c1 - c0), np_dtype)
    m = (r_all >= r0) & (r_all < r1) & (c_all >= c0) & (c_all < c1)
    blk[r_all[m] - r0, c_all[m] - c0] = v_all[m]
    return DistMatrix(local=torch.from_numpy(blk).to(grid.device), n=n,
                      grid=grid)


def gather(x: DistMatrix) -> torch.Tensor:
    """The whole zero-padded (n_m, n_m) matrix on every rank
    (gather_matrix analog, distribute_matrix.f90:185-258)."""
    return gather_block(x, 0, x.n_m, 0, x.n_m)


def gather_block(x: DistMatrix, r0: int, r1: int, c0: int, c1: int,
                 over: str = "world") -> torch.Tensor:
    """``x[r0:r1, c0:c1]`` whole on every rank of the grid ("world"), or
    of this rank's process row or column (``over``), whose ranks must
    between them hold it: one ``all_reduce`` of a zeroed buffer in which
    each rank fills the entries it holds (each entry has one owner, so the
    sum is exact)."""
    buf = torch.zeros((r1 - r0, c1 - c0), dtype=x.local.dtype,
                      device=x.local.device)
    a0, a1 = x.rows(r0, r1)
    b0, b1 = x.cols(c0, c1)
    if a1 > a0 and b1 > b0:
        buf[x.row0 + a0 - r0:x.row0 + a1 - r0,
            x.col0 + b0 - c0:x.col0 + b1 - c0] = x.local[a0:a1, b0:b1]
    return all_reduce(buf, x.grid, over=over)


def times_tall(x: DistMatrix, v: torch.Tensor, rows: tuple[int, int],
               cols: tuple[int, int]) -> torch.Tensor:
    """``x[r0:r1, c0:c1] @ v`` with ``v`` (c1 - c0, k) the same on every
    rank, whole on every rank: each block's product in this rank's rows
    of a zeroed (r1 - r0, k) buffer, summed over the grid by one
    ``all_reduce`` (the process-row reduction and the process-column
    gather in one call, as the one-stage core's column step)."""
    (r0, r1), (c0, c1) = rows, cols
    out = torch.zeros((r1 - r0, v.shape[1]), dtype=v.dtype, device=v.device)
    a0, a1 = x.rows(r0, r1)
    b0, b1 = x.cols(c0, c1)
    if a1 > a0 and b1 > b0:
        out[x.row0 + a0 - r0:x.row0 + a1 - r0] = \
            x.local[a0:a1, b0:b1] @ v[x.col0 + b0 - c0:x.col0 + b1 - c0]
    return all_reduce(out, x.grid)


def transpose(x: DistMatrix) -> DistMatrix:
    """``x^T`` on the same grid.  Block (pr, pc) of the result is
    ``x[pc*nc:(pc+1)*nc, pr*nr:(pr+1)*nr]^T``, which other ranks hold:
    each rank's block is broadcast in turn (:func:`rank_shares`) and every
    rank keeps the part it needs, so a rank holds its own block and one
    other at a time."""
    grid = x.grid
    nr, nc = x.local.shape
    out = torch.zeros_like(x.local)
    # the rows and columns of x this rank's block of x^T reads
    want_r, want_c = (x.col0, x.col0 + nc), (x.row0, x.row0 + nr)
    shapes = [(nr, nc)] * grid.size
    for q, blk in rank_shares(x.local, grid, shapes):
        qr, qc = (q // grid.C) * nr, (q % grid.C) * nc
        a0, a1 = span(*want_r, qr, nr)
        b0, b1 = span(*want_c, qc, nc)
        if a1 > a0 and b1 > b0:
            out[qc + b0 - x.row0:qc + b1 - x.row0,
                qr + a0 - x.col0:qr + a1 - x.col0] = blk[a0:a1, b0:b1].T
    return x.with_local(out)


def times_columns(x: DistMatrix, z: torch.Tensor) -> torch.Tensor:
    """``x @ z`` with ``z`` (n_m, w) this rank's own columns (each rank
    its own, e.g. a :class:`ColumnShares`' vectors), whole on this rank:
    each rank's block of x broadcast in turn (:func:`rank_shares`), every
    rank adding the block's product with its rows of z.  P broadcasts of
    a block; a rank holds its block and one other."""
    grid = x.grid
    nr, nc = x.local.shape
    out = z.new_zeros((x.n_m, z.shape[1]))
    for q, blk in rank_shares(x.local, grid, [(nr, nc)] * grid.size):
        r0, c0 = (q // grid.C) * nr, (q % grid.C) * nc
        out[r0:r0 + nr].addmm_(blk, z[c0:c0 + nc])
    return out


def submatrix(x: DistMatrix, lo: int, hi: int) -> DistMatrix:
    """``x[lo:hi, lo:hi]`` as a DistMatrix of its own on the same grid,
    zero-padded to its :func:`padded_dim`: each rank's block of x
    broadcast in turn, every rank keeping the entries of its new block."""
    grid = x.grid
    n = hi - lo
    n_m = padded_dim(n, grid)
    nr, nc = x.local.shape
    r0, r1, c0, c1 = _block_bounds(n_m, grid)
    out = torch.zeros((r1 - r0, c1 - c0), dtype=x.local.dtype,
                      device=x.local.device)
    # this rank's new block reads x's rows and columns lo + [r0, r1) etc.
    want_r = (lo + r0, lo + min(r1, n))
    want_c = (lo + c0, lo + min(c1, n))
    for q, blk in rank_shares(x.local, grid, [(nr, nc)] * grid.size):
        qr, qc = (q // grid.C) * nr, (q % grid.C) * nc
        a0, a1 = span(*want_r, qr, nr)
        b0, b1 = span(*want_c, qc, nc)
        if a1 > a0 and b1 > b0:
            out[qr + a0 - lo - r0:qr + a1 - lo - r0,
                qc + b0 - lo - c0:qc + b1 - lo - c0] = blk[a0:a1, b0:b1]
    return DistMatrix(local=out, n=n, grid=grid)


def diagonal(x: DistMatrix) -> torch.Tensor:
    """The (n_m,) diagonal of ``x`` whole on every rank (one
    ``all_reduce`` of slots)."""
    nr, nc = x.local.shape
    rows = torch.arange(x.row0, x.row0 + nr, device=x.local.device)
    at = rows - x.col0
    here = (at >= 0) & (at < nc)
    return gather_slots(x.local[here, at[here]], rows[here], (x.n_m,),
                        x.grid)


def matmul(a: DistMatrix, b: DistMatrix, *, trans_a: bool = False,
           trans_b: bool = False, rows: Optional[tuple[int, int]] = None,
           cols: Optional[tuple[int, int]] = None,
           inner: Optional[tuple[int, int]] = None,
           panel: int = 256) -> DistMatrix:
    """``C = op(a)[r0:r1, k0:k1] @ op(b)[k0:k1, c0:c1]`` in the block
    [r0:r1, c0:c1] of a zero (n_m, n_m) DistMatrix (``rows``, ``cols``,
    ``inner`` default to everything; ``op`` transposes by
    :func:`transpose` first).  SUMMA on plain blocks: the inner range is
    cut at every edge of a's column blocks and b's row blocks and every
    ``panel`` columns, so each k-panel has one owning process column in a
    and one owning process row in b; the owner broadcasts a's panel
    along its process row and b's panel along its process column, and
    every rank adds the local product.  Two collectives a panel."""
    if trans_a:
        a = transpose(a)
    if trans_b:
        b = transpose(b)
    grid = a.grid
    n = a.n_m
    nr, nc = a.local.shape
    r0, r1 = rows or (0, n)
    c0, c1 = cols or (0, n)
    k0, k1 = inner or (0, n)
    out = torch.zeros_like(a.local)
    ra, rb = a.rows(r0, r1)
    ca, cb = a.cols(c0, c1)
    cuts = sorted({k0, k1} | {k for k in range(0, n, nc) if k0 < k < k1}
                  | {k for k in range(0, n, nr) if k0 < k < k1}
                  | set(range(k0, k1, panel)))
    for s, e in zip(cuts[:-1], cuts[1:]):
        oc, orow = s // nc, s // nr       # owners of a's and b's panels
        ap = a.local[:, s - oc * nc:e - oc * nc].contiguous() \
            if grid.pc == oc else a.local.new_empty((nr, e - s))
        broadcast(ap, grid, grid.pr * grid.C + oc, over="row")
        bp = b.local[s - orow * nr:e - orow * nr].contiguous() \
            if grid.pr == orow else b.local.new_empty((e - s, nc))
        broadcast(bp, grid, orow * grid.C + grid.pc, over="col")
        if rb > ra and cb > ca:
            out[ra:rb, ca:cb].addmm_(ap[ra:rb], bp[:, ca:cb])
    return a.with_local(out)


def fill_padding_diagonal(x: DistMatrix, value) -> DistMatrix:
    """A copy of ``x`` with ``value`` on the padding diagonal (rows and
    columns >= x.n): identity for B, the Gershgorin sentinel for a
    standard matrix (JAX ``solvers/api.py:43-83``,
    ``pipelines.py:323-326``)."""
    nr, nc = x.local.shape
    rows = torch.arange(x.row0, x.row0 + nr, device=x.local.device)
    at = rows - x.col0
    pad = (rows >= x.n) & (at >= 0) & (at < nc)
    local = x.local.clone()
    local[pad, at[pad]] = value
    return x.with_local(local)


def local_eye(like: DistMatrix) -> DistMatrix:
    """The (n_m, n_m) identity on ``like``'s grid."""
    nr, nc = like.local.shape
    rows = torch.arange(like.row0, like.row0 + nr, device=like.local.device)
    cols = torch.arange(like.col0, like.col0 + nc, device=like.local.device)
    eye = (rows[:, None] == cols[None, :]).to(like.local.dtype)
    return like.with_local(eye)


def global_index(x: DistMatrix):
    """(rows (nr, 1), cols (1, nc)): the global indices of this block's
    entries."""
    nr, nc = x.local.shape
    dev = x.local.device
    return (torch.arange(x.row0, x.row0 + nr, device=dev)[:, None],
            torch.arange(x.col0, x.col0 + nc, device=dev)[None, :])


def print_grid_mapping(grid: ProcessGrid, file=None) -> None:
    """Print the rank at each (row, col) grid coordinate
    (print_map_of_grid_to_processes analog, processes.f90:68-107)."""
    file = file or sys.stdout
    r, c = grid.R, grid.C
    print(f"Grid mapping: {r} x {c} devices", file=file)
    header = "        " + " ".join(f"col{j:4d}" for j in range(c))
    print(header, file=file)
    for i in range(r):
        row = " ".join(f"{i * c + j:7d}" for j in range(c))
        print(f"row{i:4d} {row}", file=file)
