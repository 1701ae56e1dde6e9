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

Every sharded step is written on ``all_reduce`` and ``broadcast`` alone:
torch's backend table documents gloo as taking CUDA tensors for those two
only, so the same code runs under NCCL, gloo on CPU tensors and gloo on
CUDA tensors (several ranks on one card).  A gather of small results is
an ``all_reduce`` of a zeroed buffer in which each rank fills its own slot
(:func:`gather_slots`); a product that needs every rank's share of a
large operand takes the shares one at a time, each rank's broadcast in
turn (:func:`rank_shares`), so no rank ever holds more than its own share
and one other.  Nothing here moves a tensor to the host for a backend.
Each grid counts its collectives and the host seconds spent in them
(:class:`CollectiveStats`; under NCCL a call returns once it is queued,
so its seconds are the queueing).
"""

from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

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
    """Collectives a grid made and the host seconds spent in them."""

    calls: int = 0
    seconds: float = 0.0
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
    t0 = time.perf_counter()
    dist.all_reduce(x, op=_OPS[op], group=_group(grid, over))
    grid.stats.seconds += time.perf_counter() - t0
    grid.stats.calls += 1
    grid.stats.bytes += x.numel() * x.element_size()
    return x


def broadcast(x: torch.Tensor, grid: ProcessGrid, src: int) -> torch.Tensor:
    """In-place ``broadcast`` of ``x`` from grid rank ``src``; returns x."""
    t0 = time.perf_counter()
    dist.broadcast(x, src)
    grid.stats.seconds += time.perf_counter() - t0
    grid.stats.calls += 1
    grid.stats.bytes += x.numel() * x.element_size()
    return x


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
    """A symmetric matrix on the grid: this rank's block
    ``A[pr*nr:(pr+1)*nr, pc*nc:(pc+1)*nc]`` of the zero-padded
    (n_m, n_m) matrix, ``n`` its logical dimension."""

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
    grid = x.grid
    nr, nc = x.local.shape
    return gather_slots(x.local, (slice(x.row0, x.row0 + nr),
                                  slice(x.col0, x.col0 + nc)),
                        (x.n_m, x.n_m), grid)


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
