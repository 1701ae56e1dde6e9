"""Solver pipelines: the SEP cores on a standard problem.

Counterpart of ``eigenkernel_tpu/solvers/pipelines.py``, for the cores this
package runs so far:

  'one_stage' = blocked Householder tridiagonalization (pdsytrd analog)
              + bisection / inverse-iteration tridiagonal solve (pdsyevx)
              + compact-WY back-transform (pdormtr)
  'two_stage' = full -> band -> tridiagonal (eigen_sx / ELPA2 analog,
                :mod:`.twostage`) + the same tridiagonal solve
                + chase and band back-transforms

Each stage is timed into the context's :class:`EventLog` under the
reference's hierarchical names (``sep:tridiagonalize``,
``sep:full_to_band``, ``sep:band_to_tridiag``, ``sep:tridiag_eigh``,
``sep:back_transform``), with a ``torch.cuda.synchronize()`` before each
clock stops, and its model GFLOP/s as ``!<stage>_Gflops``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from eigenkernel_tpu_torch.core.config import DEFAULT_BLOCK_SIZE
from eigenkernel_tpu_torch.obs import flops as fl
from eigenkernel_tpu_torch.obs.events import EventLog, barrier
from eigenkernel_tpu_torch.ops import householder
from eigenkernel_tpu_torch.ops import tridiag as td

# SEP cores of the registry that are still to be ported, with their
# ROADMAP items
_NOT_PORTED = {
    "eigh": "eigh core: ROADMAP slice 1b",
    "jacobi": "block-Jacobi core: ROADMAP slice 6",
    "qdwh": "QDWH spectral divide-and-conquer core: ROADMAP slice 6",
}


@dataclass
class SolverContext:
    device: torch.device
    block_size: int = DEFAULT_BLOCK_SIZE
    log: Optional[EventLog] = None

    def tick(self, name: str, t0: float,
             flops: Optional[float] = None) -> None:
        if self.log is None:
            return
        barrier(self.device)
        dt = time.time() - t0
        self.log.add_event(name, dt)
        if flops and dt > 0:
            self.log.add_event(f"!{name}_Gflops", flops / dt / 1e9)


def _run(ctx: SolverContext, name: str, fn: Callable, *args,
         flops: Optional[float] = None) -> Any:
    t0 = time.time()
    out = fn(*args)
    ctx.tick(name, t0, flops=flops)
    return out


def sep_one_stage(ctx: SolverContext, a: torch.Tensor, n_vec: int):
    """pdsytrd + tridiagonal solve + pdormtr analog (see module doc)."""
    n = a.shape[0]
    tri = _run(ctx, "sep:tridiagonalize", householder.tridiagonalize,
               a, ctx.block_size, flops=fl.tridiagonalize(n))
    w, z = _run(ctx, "sep:tridiag_eigh", td.tridiag_eigh, tri.d, tri.e,
                n_vec, flops=fl.bisect_invit(n, n_vec))
    z = _run(ctx, "sep:back_transform", householder.apply_q, tri, z,
             ctx.block_size, flops=fl.back_transform_one_stage(n, n_vec))
    return w, z


def standard_pipeline(ctx: SolverContext, a: torch.Tensor, n_vec: int,
                      core: str):
    """Standard EVP: run the SEP core (no padding in this package)."""
    if core == "one_stage":
        return sep_one_stage(ctx, a, n_vec)
    if core == "two_stage":
        from eigenkernel_tpu_torch.solvers.twostage import sep_two_stage

        return sep_two_stage(ctx, a, n_vec)
    raise NotImplementedError(_NOT_PORTED.get(core, f"SEP core '{core}'"))
