"""Top-level ``solve`` — the ``eigen_solver`` entry point.

Counterpart of ``eigenkernel_tpu/solvers/api.py``: dispatch the ``-s``
name, place the matrices on the device, run the standard or generalized
pipeline, slice the requested eigenpairs.  On one device there is no
padding: every op here takes any n.  ``dtype='mixed'`` runs the pipeline
in float32 and refines its eigenpairs against float64 copies of the
caller's matrices (``ops/refine.py``).

On a process grid (``mesh=``, JAX ``api.py:145-195``) the matrix is
zero-padded to the grid's ``padded_dim`` with a Gershgorin sentinel on the
padding diagonal, so its lowest n pairs are the logical ones, and the
one-stage and two-stage cores run sharded; B is padded with identity on
its padding diagonal (JAX ``api.py:43-83``) and the generalized
reduction and recovery run on the grid.  ``lapack``, ``eigh`` and
``general_eigh``'s core run replicated on every rank, as in the JAX
package, and every rank keeps its share of the columns.  The ``jacobi``
core runs on block columns (``ops/jacobi.py``), the ``qdwh`` core's
recursion on the grid (``ops/qdwh.py``), and ``dtype='mixed'`` refines
the grid's float32 column shares against float64 blocks of the caller's
matrices (``ops/refine.py::refine_on_grid``): every registry name runs on
a grid, in every dtype.

:func:`fused_solver` is the JAX package's ``fused_solver``
(``api.py:258-295``): one callable for a named pipeline on operands
already placed, with no event log and no padding.
"""

from __future__ import annotations

import os
import time
from typing import Any, Optional

import numpy as np
import torch

from eigenkernel_tpu_torch.core.config import (DEFAULT_BLOCK_SIZE,
                                              set_matmul_precision_highest)
from eigenkernel_tpu_torch.core.types import EigenPairs
from eigenkernel_tpu_torch.obs import events
from eigenkernel_tpu_torch.obs.events import EventLog
from eigenkernel_tpu_torch.obs.mem import memstats
from eigenkernel_tpu_torch.ops.refine import refine_eigenpairs, refine_on_grid
from eigenkernel_tpu_torch.parallel import mesh as pm
from eigenkernel_tpu_torch.solvers import pipelines as pl
from eigenkernel_tpu_torch.solvers.registry import (AUTO_NAMES, get_spec,
                                                    resolve_auto)

_DTYPES = {"float64": torch.float64, "float32": torch.float32}


def _as_dtype(dtype: Any, a: Any) -> torch.dtype:
    if dtype is None:
        if isinstance(a, torch.Tensor) and a.dtype in _DTYPES.values():
            return a.dtype
        if isinstance(a, np.ndarray) and a.dtype == np.float32:
            return torch.float32
        return torch.float64
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[np.dtype(dtype).name]


def solve(a: Any, b: Any = None, solver: str = "general_elpa2",
          n_vec: Optional[int] = None, block_size: int = 0,
          log: Optional[EventLog] = None, dtype: Any = None,
          device: Any = None, mesh: Optional[pm.ProcessGrid] = None,
          n_logical: Optional[int] = None) -> EigenPairs:
    """Solve ``A x = lambda x``, or ``A x = lambda B x`` with B SPD (the
    default ``solver`` is the JAX package's, ``general_elpa2``, so a
    standard problem names its solver).

    ``a`` and ``b`` are dense symmetric matrices (numpy arrays or torch
    tensors); they are copied to ``device`` (default: ``a``'s own device
    for a tensor, else ``cuda``) in ``dtype`` (default: ``a``'s float type,
    else float64).  ``dtype='mixed'`` runs the pipeline in float32, then
    refines the eigenpairs in float64 against ``a`` (and ``b``) as given
    (event ``solve:refine``) and returns float64.  Returns the ``n_vec``
    lowest eigenvalues ascending and their eigenvectors in columns,
    B-orthonormal for a generalized problem (the dsygv convention).

    With ``mesh`` (a :class:`~eigenkernel_tpu_torch.parallel.mesh.ProcessGrid`,
    called on every rank) ``a`` is a DistMatrix on it, or the whole
    matrix on every rank, of which each rank takes its block; the solve
    runs on the grid's device and returns this rank's columns
    (:class:`EigenPairs` ``grid`` and ``cols``).  ``n_logical`` is the
    logical dimension of an ``a`` that carries zero padding.
    """
    if n_logical is not None:
        n = int(n_logical)
    else:
        n = a.n if isinstance(a, pm.DistMatrix) else int(a.shape[0])
    if solver in AUTO_NAMES:
        solver = resolve_auto(solver, n, generalized=b is not None,
                              selecting=n_vec is not None and n_vec != n,
                              on_mesh=mesh is not None, backend="cuda")
    spec = get_spec(solver)
    if spec.generalized != (b is not None):
        kind = "generalized" if b is not None else "standard"
        raise ValueError(f"solver '{solver}' is not for {kind} problems")
    if not spec.selecting and n_vec is not None and n_vec != n:
        raise ValueError(
            f"solver '{solver}' does not support partial computation")
    n_vec = n if n_vec is None else int(n_vec)
    if not 0 < n_vec <= n:
        raise ValueError(f"n_vec={n_vec} out of range for n={n}")
    mixed = isinstance(dtype, str) and dtype == "mixed"
    # EK_SELECT_CORE=one_stage|two_stage pins a selecting solver's SEP core,
    # as in the JAX package.  Its 'auto' picks the two-stage core only on a
    # TPU (a TPU crossover, not re-measured here), so 'auto' keeps the
    # registry's one-stage core.
    core = spec.core
    if spec.selecting and core == "one_stage":
        sel = os.environ.get("EK_SELECT_CORE", "auto")
        if sel in ("one_stage", "two_stage"):
            core = sel
    if mesh is not None:
        return _solve_grid(a, b, spec, core, n, n_vec, block_size, log,
                           dtype, mesh)
    if a.shape[0] != a.shape[1] or (b is not None
                                    and tuple(b.shape) != tuple(a.shape)):
        raise ValueError("matrix dimension mismatch")
    torch_dtype = torch.float32 if mixed else _as_dtype(dtype, a)
    if device is None:
        device = a.device if isinstance(a, torch.Tensor) else "cuda"
    device = torch.device(device)

    set_matmul_precision_highest()
    a_dev = torch.as_tensor(a).to(device=device, dtype=torch_dtype)
    panel = block_size if block_size > 0 else DEFAULT_BLOCK_SIZE
    ctx = pl.SolverContext(device=device, block_size=panel, log=log)
    if b is None:
        w, z = pl.standard_pipeline(ctx, a_dev, n_vec, core)
    else:
        b_dev = torch.as_tensor(b).to(device=device, dtype=torch_dtype)
        w, z = pl.generalized_pipeline(ctx, a_dev, b_dev, n_vec, core,
                                       spec.reduction)
        del b_dev
    values, vectors = w[:n_vec], z[:, :n_vec]
    if mixed:
        # refine against the caller's matrices in float64, not the
        # float32 pipeline copies, which are freed first
        t0 = time.time()
        with events.stage("solve:refine", log):
            v64 = vectors.to(torch.float64)
            del a_dev, w, z, values, vectors
            a64 = torch.as_tensor(a).to(device=device, dtype=torch.float64)
            b64 = None if b is None else \
                torch.as_tensor(b).to(device=device, dtype=torch.float64)
            memstats("solve:pre_refine")
            values, vectors = refine_eigenpairs(a64, v64, b64)
            ctx.tick("solve:refine", t0)
    return EigenPairs(values=values, vectors=vectors,
                      meta={"solver": solver, "core": core, "panel": panel,
                            "device": str(device)})


def _on_grid(x, grid: pm.ProcessGrid, dtype: torch.dtype,
             n: int) -> pm.DistMatrix:
    """``x`` (a DistMatrix, or the whole matrix on every rank) as a
    DistMatrix on ``grid``'s device in ``dtype``."""
    if isinstance(x, pm.DistMatrix):
        if x.grid is not grid:
            raise ValueError("solve: the matrix is on another grid")
        return pm.DistMatrix(x.local.to(device=grid.device, dtype=dtype),
                             n, grid)
    return pm.distribute(x, grid, dtype, n)


def _solve_grid(a, b, spec, core: str, n: int, n_vec: int, block_size: int,
                log: Optional[EventLog], dtype: Any,
                grid: pm.ProcessGrid) -> EigenPairs:
    """A solve on ``grid``; ``dtype='mixed'`` runs the pipeline in float32
    and refines this rank's columns against float64 blocks of ``a`` (and
    ``b``) as given (a float64 DistMatrix, e.g. the CLI's, is taken as
    it is)."""
    src = a.local if isinstance(a, pm.DistMatrix) else a
    mixed = isinstance(dtype, str) and dtype == "mixed"
    torch_dtype = torch.float32 if mixed else _as_dtype(dtype, src)
    set_matmul_precision_highest()
    dm = _on_grid(a, grid, torch_dtype, n)
    panel = block_size if block_size > 0 else DEFAULT_BLOCK_SIZE
    ctx = pl.SolverContext(device=grid.device, block_size=panel, log=log,
                           mesh=grid)
    if b is None:
        if core != "eigh":
            dm = pl.sentinelize(dm)
        out = pl.SEP_CORES[core](ctx, dm, n_vec)
    else:
        bm = pm.fill_padding_diagonal(_on_grid(b, grid, torch_dtype, n), 1.0)
        out = pl.generalized_pipeline(ctx, dm, bm, n_vec, core,
                                      spec.reduction)
        del bm
    del dm
    keep = out.cols < n_vec
    out = pm.ColumnShares(out.values[:n_vec], out.vectors[:, keep],
                          out.cols[keep])
    if mixed:
        # the float32 copies go first, as on one device
        t0 = time.time()
        with events.stage("solve:refine", log):
            out = out._replace(vectors=out.vectors.to(torch.float64))
            a64 = _on_grid(a, grid, torch.float64, n)
            b64 = None if b is None else _on_grid(b, grid, torch.float64, n)
            memstats("solve:pre_refine")
            out = refine_on_grid(a64, out, b64)
            del a64, b64
            ctx.tick("solve:refine", t0)
    return EigenPairs(values=out.values, vectors=out.vectors[:n],
                      meta={"solver": spec.name, "core": core,
                            "panel": panel, "device": str(grid.device),
                            "grid": (grid.R, grid.C)},
                      grid=grid, cols=out.cols)


def fused_solver(solver: str, n: int, n_vec: Optional[int] = None,
                 mesh: Optional[pm.ProcessGrid] = None, block_size: int = 0):
    """One callable for a named pipeline (JAX ``fused_solver``).

    The returned ``fn(a[, b]) -> (values, vectors)`` runs the whole solve
    with no event log, no padding and no copy: ``a`` (and ``b`` for a
    generalized name) are tensors already on the device, or, with
    ``mesh`` (called on every rank), DistMatrix on it, and then
    ``vectors`` is this rank's
    :class:`~eigenkernel_tpu_torch.parallel.mesh.ColumnShares`.  ``n``
    must already be divisible by the panel (and, on a grid, be its own
    ``padded_dim``).  The ``qdwh`` core raises ``ValueError``, as in the
    JAX package.
    """
    if solver in AUTO_NAMES:
        solver = resolve_auto(solver, n, generalized=solver.startswith("g"),
                              selecting=n_vec is not None and n_vec != n,
                              on_mesh=mesh is not None, backend="cuda")
    spec = get_spec(solver)
    if spec.core == "qdwh":
        raise ValueError(
            f"solver '{solver}' (QDWH spectral D&C) runs host-staged "
            "recursion with data-dependent splits and cannot be fused "
            "into one jittable computation — use solve() instead")
    panel = min(block_size if block_size > 0 else DEFAULT_BLOCK_SIZE, n)
    if n % panel != 0:
        raise ValueError(f"n={n} must be divisible by panel {panel}")
    if mesh is not None and pm.padded_dim(n, mesh) != n:
        raise ValueError(f"n={n} must be divisible by the grid "
                         f"{mesh.R} x {mesh.C}")
    k = n if n_vec is None else int(n_vec)

    def run(a, b=None):
        set_matmul_precision_highest()
        ctx = pl.SolverContext(
            device=mesh.device if mesh is not None else a.device,
            block_size=panel, mesh=mesh)
        if spec.generalized:
            out = pl.generalized_pipeline(ctx, a, b, k, spec.core,
                                          spec.reduction)
        else:
            out = pl.standard_pipeline(ctx, a, k, spec.core)
        if mesh is None:
            return out[0][:k], out[1][:, :k]
        keep = out.cols < k
        return out.values[:k], pm.ColumnShares(out.values[:k],
                                               out.vectors[:, keep],
                                               out.cols[keep])

    if spec.generalized:
        def fn(a, b):
            return run(a, b)
    else:
        def fn(a):
            return run(a)
    return fn
