"""Solver pipelines: reduction strategy x SEP core x recovery.

Counterpart of ``eigenkernel_tpu/solvers/pipelines.py``:

  reduction:  'scalapack' / 'scalapack_new' = Cholesky + triangular solves
              (pdpotrf + pdsygst / pdsyngst), 'elpa' = Cholesky + explicit
              inverse + products (:mod:`..ops.reduction`)
  SEP core:   'one_stage' = blocked Householder tridiagonalization
              (pdsytrd) + tridiagonal solve (divide and conquer for half
              the spectrum or more, else bisection / inverse iteration)
              + compact-WY back-transform (pdormtr)
              'two_stage' = full -> band -> tridiagonal (eigen_sx / ELPA2
              analog, :mod:`.twostage`) + the same tridiagonal solve
              + chase and band back-transforms
              'eigh' = ``torch.linalg.eigh`` (cuSOLVER on the card)
              'jacobi' = block Jacobi (:mod:`..ops.jacobi`, the pair
              eigh in kernel D2)
              'qdwh' = QDWH spectral divide and conquer
              (:mod:`..ops.qdwh`)
  recovery:   triangular solve or product with the stored inverse,
              matching the reduction

Each stage is timed into the context's :class:`EventLog` under the
reference's hierarchical names (``solve:reduce_elpa``,
``reduce_generalized[_new]``, ``sep:tridiagonalize``,
``sep:full_to_band``, ``sep:band_to_tridiag``, ``sep:tridiag_eigh``,
``sep:back_transform``, ``sep:eigh``, ``sep:jacobi``, ``sep:qdwh_dc``,
``recovery_generalized``), with a
``torch.cuda.synchronize()`` before each clock stops (the span
``wait:drain``), and its model GFLOP/s as ``!<stage>_Gflops``.  For the
length of a stage the context's log is the active log of
:func:`~eigenkernel_tpu_torch.obs.events.span` (``obs/events.py``).

On a process grid (``SolverContext.mesh``) the one-stage, two-stage,
``jacobi`` and ``qdwh`` cores run sharded (the matrix a
:class:`~eigenkernel_tpu_torch.parallel.mesh.DistMatrix`, the result a
:class:`~eigenkernel_tpu_torch.parallel.mesh.ColumnShares`), the ``eigh``
core replicated on every rank, and the generalized pipeline's reduction
and recovery on the grid (JAX ``pipelines.py:150-177``): the reduced
matrix gets the Gershgorin sentinel on its padding diagonal before the
core, as the JAX package sentinelizes ``a_std``.  Every stage's clock
stops after a barrier over the grid too, so its seconds are the slowest
rank's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from eigenkernel_tpu_torch.core.config import DEFAULT_BLOCK_SIZE
from eigenkernel_tpu_torch.obs import flops as fl
from eigenkernel_tpu_torch.obs import events
from eigenkernel_tpu_torch.obs.events import EventLog, barrier
from eigenkernel_tpu_torch.ops import householder, jacobi, qdwh
from eigenkernel_tpu_torch.ops import reduction as red
from eigenkernel_tpu_torch.ops.blocked import GEMM_BLOCK, gershgorin_sentinel
from eigenkernel_tpu_torch.ops import tridiag as td
from eigenkernel_tpu_torch.parallel import mesh as pm


@dataclass
class SolverContext:
    device: torch.device
    block_size: int = DEFAULT_BLOCK_SIZE
    log: Optional[EventLog] = None
    mesh: Optional[pm.ProcessGrid] = None
    gemm_block: int = GEMM_BLOCK   # the grid reductions' panel width

    def tick(self, name: str, t0: float,
             flops: Optional[float] = None) -> None:
        if self.log is None:
            return
        with events.span("wait:drain"):
            barrier(self.device)
            if self.mesh is not None:
                pm.barrier(self.mesh)
        dt = time.time() - t0
        self.log.add_event(name, dt)
        if flops and dt > 0:
            self.log.add_event(f"!{name}_Gflops", flops / dt / 1e9)


def _run(ctx: SolverContext, name: str, fn: Callable, *args,
         flops: Optional[float] = None, **kwargs) -> Any:
    t0 = time.time()
    with events.stage(name, ctx.log):
        out = fn(*args, **kwargs)
        ctx.tick(name, t0, flops=flops)
    return out


def tridiag_eigh(d: torch.Tensor, e: torch.Tensor, n_vec: int,
                 mesh: Optional[pm.ProcessGrid] = None,
                 n_logical: Optional[int] = None):
    """``td.tridiag_eigh``; on a grid whose matrix is padded past
    ``n_logical``, the padding's eigenpairs are left out, and the vectors
    get zero padding rows.  T splits exactly there by construction: every
    reflector is zero on the padding rows, so ``e[n_logical - 1]`` is 0
    exactly (checked, on (d, e), the same on every rank).  The padding's
    sentinel (kept for the cores that solve the padded matrix whole)
    would otherwise sit inside the solve and widen each merge's deflation
    tolerance in divide and conquer, which scales with the largest pole
    (the float32 ``eigensx`` at n = 131 on a 2 x 2 grid then misses its
    residual bar)."""
    n_m = d.shape[0]
    if mesh is None or n_logical is None or n_logical >= n_m:
        return td.tridiag_eigh(d, e, n_vec, mesh)
    with events.span("wait:padding_split"):
        split = float(e[n_logical - 1])
    if split != 0.0:
        raise RuntimeError(f"tridiag_eigh: T does not split at the padding "
                           f"(e[{n_logical - 1}] = {split})")
    out = td.tridiag_eigh(d[:n_logical], e[:n_logical - 1], n_vec, mesh)
    z = out.vectors.new_zeros((n_m, out.vectors.shape[1]))
    z[:n_logical] = out.vectors
    return out._replace(vectors=z)


def sep_one_stage(ctx: SolverContext, a, n_vec: int):
    """pdsytrd + tridiagonal solve + pdormtr analog (see module doc).  On
    a grid ``a`` is a DistMatrix and the result a ColumnShares."""
    mesh = ctx.mesh
    n = a.shape[0] if mesh is None else a.n_m
    tri = _run(ctx, "sep:tridiagonalize", householder.tridiagonalize,
               a, ctx.block_size, mesh, flops=fl.tridiagonalize(n))
    out = _run(ctx, "sep:tridiag_eigh", tridiag_eigh, tri.d, tri.e, n_vec,
               mesh, None if mesh is None else a.n,
               flops=fl.tridiag_eigh(n, n_vec))
    z = _run(ctx, "sep:back_transform", householder.apply_q, tri, out[1],
             ctx.block_size, mesh, flops=fl.back_transform_one_stage(n, n_vec))
    if mesh is None:
        return out[0], z
    return out._replace(vectors=z)


def sep_two_stage(ctx: SolverContext, a, n_vec: int):
    """eigen_sx / ELPA2 analog: full -> band -> tridiagonal, then solve."""
    from eigenkernel_tpu_torch.solvers.twostage import sep_two_stage as impl

    return impl(ctx, a, n_vec)


def sep_eigh(ctx: SolverContext, a, n_vec: int):
    """The library core: one ``torch.linalg.eigh`` (cuSOLVER's syevd on
    the card).  On a grid the logical matrix is gathered and solved on
    every rank (as ``lapack``; XLA gathers it for the JAX package), each
    rank keeping its run of the columns, zero on the padding rows."""
    if ctx.mesh is None:
        w, z = _run(ctx, "sep:eigh", torch.linalg.eigh, a,
                    flops=fl.eigh(a.shape[0]))
        return w[:n_vec], z[:, :n_vec]
    full = pm.gather(a)[:a.n, :a.n]
    w, z = _run(ctx, "sep:eigh", torch.linalg.eigh, full,
                flops=fl.eigh(a.n))
    del full
    out = pm.contiguous_shares(w[:n_vec], z[:, :n_vec], ctx.mesh)
    pad = out.vectors.new_zeros((a.n_m, out.vectors.shape[1]))
    pad[:a.n] = out.vectors
    return out._replace(vectors=pad)


def sentinelize(a: pm.DistMatrix) -> pm.DistMatrix:
    """The Gershgorin sentinel on a grid matrix's padding diagonal: the
    lowest n pairs of the padded matrix are then the logical ones."""
    if a.n_m == a.n:
        return a
    return pm.fill_padding_diagonal(a, gershgorin_sentinel(a, a.grid))


def sep_jacobi(ctx: SolverContext, a, n_vec: int):
    """Block-Jacobi core (``ops/jacobi.py``): no sequential panel
    recurrence, a batched pair eigh (kernel D2) and full-width products a
    round; the panel width is the block width.  On a grid the matrix is
    held in block columns, a rank's tournament pairs each
    (``jacobi.block_jacobi_on_grid``)."""
    if ctx.mesh is not None:
        return _run(ctx, "sep:jacobi", jacobi.block_jacobi_on_grid, a,
                    ctx.block_size, 0, n_vec, flops=fl.jacobi(a.n_m))
    w, z = _run(ctx, "sep:jacobi", jacobi.block_jacobi_eigh, a,
                ctx.block_size, flops=fl.jacobi(a.shape[0]))
    return w[:n_vec], z[:, :n_vec]


def sep_qdwh(ctx: SolverContext, a, n_vec: int):
    """QDWH spectral divide-and-conquer core (``ops/qdwh.py``), a host
    recursion on exact sizes.  The JAX core passes its GEMM block to the
    Cholesky and triangular solves; here they are whole-matrix
    ``torch.linalg`` calls on one device, so there is no block to pass.
    On a grid the splits run on DistMatrix ops with the grid's panel
    width (``qdwh.spectral_dc_on_grid``)."""
    if ctx.mesh is not None:
        out = _run(ctx, "sep:qdwh_dc", qdwh.spectral_dc_on_grid, a,
                   block=ctx.gemm_block, flops=fl.qdwh_dc(a.n_m))
        keep = out.cols < n_vec
        return pm.ColumnShares(out.values[:n_vec], out.vectors[:, keep],
                               out.cols[keep])
    w, z = _run(ctx, "sep:qdwh_dc", qdwh.spectral_dc_eigh, a,
                flops=fl.qdwh_dc(a.shape[0]))
    return w[:n_vec], z[:, :n_vec]


SEP_CORES = {
    "one_stage": sep_one_stage,
    "two_stage": sep_two_stage,
    "eigh": sep_eigh,
    "jacobi": sep_jacobi,
    "qdwh": sep_qdwh,
}


def standard_pipeline(ctx: SolverContext, a: torch.Tensor, n_vec: int,
                      core: str):
    """Standard EVP: run the SEP core (no padding in this package)."""
    return SEP_CORES[core](ctx, a, n_vec)


_REDUCTIONS = {
    # style: (event, function, flop model), the JAX package's names
    "elpa": ("solve:reduce_elpa", red.reduce_elpa, fl.reduce_elpa),
    "scalapack_new": ("reduce_generalized_new", red.reduce_scalapack_new,
                      fl.reduce_scalapack),
    "scalapack": ("reduce_generalized", red.reduce_scalapack,
                  fl.reduce_scalapack),
}


def generalized_pipeline(ctx: SolverContext, a, b, n_vec: int, core: str,
                         reduction_style: str):
    """Generalized EVP: reduce, SEP core, recover.  The vectors
    ``x = L^{-T} z`` are B-orthonormal as they come (the dsygv
    convention): no renormalizing.  On a grid ``a`` and ``b`` are
    DistMatrix (B with identity on its padding diagonal) and the result
    a ColumnShares."""
    sep = SEP_CORES[core]
    mesh = ctx.mesh
    n = a.shape[0] if mesh is None else a.n_m
    event, reduce, model = _REDUCTIONS[reduction_style]
    r = _run(ctx, event, reduce, a, b, mesh, ctx.gemm_block, flops=model(n))
    a_std, r = r.a_std, r._replace(a_std=None)
    if mesh is not None:
        a_std = sentinelize(a_std)
    out = sep(ctx, a_std, n_vec)
    del a_std
    z = out[1] if mesh is None else out.vectors
    x = _run(ctx, "recovery_generalized", red.recover, r, z, mesh,
             ctx.gemm_block, flops=fl.recover(n, n_vec))
    if mesh is None:
        return out[0], x
    return out._replace(vectors=x)
