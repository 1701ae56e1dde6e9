"""Entry points of the port: one solve as a callable, the multi-process dry
run and the registry sweep on a process grid.

Counterpart of the JAX package's ``__graft_entry__.py``:

* :func:`entry` returns ``(fn, example_args)``: ``fused_solver``'s
  ``general_elpa1`` at n = 256, panel 64, on a float32 pencil on the card.
* :func:`dryrun_multichip` starts ``n_processes`` ranks
  (``parallel/multihost.run_ranks``: NCCL with a card a rank where there
  are that many cards, gloo otherwise, on the one card or on the CPU),
  runs ``general_elpa2`` through ``fused_solver`` on a
  ``layout_grid(n_processes)`` grid, then, unless ``EK_DRYRUN_SWEEP=0``,
  :func:`sweep_solvers_on_grid` at ``EK_DRYRUN_N`` (256) and
  ``EK_DRYRUN_N2`` (512).
* :func:`sweep_solvers_on_grid` solves every registry name on a grid and
  asserts the scaled residual.

    python -m eigenkernel_tpu_torch.entry [n_processes] [--platform cpu]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch


def _example_pencil(n: int, dtype):
    """The JAX entry's pencil: A symmetric, B = R R^T + n I (seed 0)."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    br = rng.standard_normal((n, n))
    b = br @ br.T + n * np.eye(n)
    return a.astype(dtype), b.astype(dtype)


def entry(device="cuda"):
    """(fn, example_args): the one-stage generalized pipeline
    (``general_elpa1``) as one callable, and its float32 pencil on
    ``device``."""
    from eigenkernel_tpu_torch.solvers.api import fused_solver

    n = 256
    fn = fused_solver("general_elpa1", n=n, block_size=64)
    a, b = _example_pencil(n, np.float32)
    return fn, (torch.tensor(a, device=device), torch.tensor(b, device=device))


def sweep_solvers_on_grid(grid, n: int, dtype=np.float32, tol: float = 5e-5,
                          n_two: int = 0) -> dict:
    """Solve every registry name on ``grid`` (called on every rank) at
    size ``n`` and assert the scaled residual ``max_j ||A v_j - lambda_j
    [B] v_j|| / ||A||_F < tol``; returns {name: max residual}.  Selecting
    names take the lowest n // 8 pairs; single-device names (``lapack``)
    run off the grid, on its device, as in the JAX package; two-stage
    names run at ``n_two`` (>= n), so that the chunked chase and the
    sharded back-transform engage.  Rank 0 prints a line a name."""
    from eigenkernel_tpu_torch.parallel import mesh as pm
    from eigenkernel_tpu_torch.solvers.api import solve
    from eigenkernel_tpu_torch.solvers.registry import SOLVERS
    from eigenkernel_tpu_torch.verify.verifier import eval_residual_norm

    tdtype = torch.float32 if np.dtype(dtype) == np.float32 else \
        torch.float64
    pencils = {}
    results = {}
    for name, spec in SOLVERS.items():
        n_use = max(n, n_two) if spec.core == "two_stage" else n
        if n_use not in pencils:
            pencils[n_use] = _example_pencil(n_use, dtype)
        a, b = pencils[n_use]
        b = b if spec.generalized else None
        n_vec = max(1, n_use // 8) if spec.selecting else None
        if spec.single_device:
            a_in, b_in = a, b
            pairs = solve(a, b, solver=name, n_vec=n_vec, device=grid.device,
                          dtype=tdtype)
        else:
            a_in = pm.distribute(a, grid, tdtype)
            b_in = None if b is None else pm.distribute(b, grid, tdtype)
            pairs = solve(a_in, b_in, solver=name, n_vec=n_vec, mesh=grid)
        mx = eval_residual_norm(a_in, pairs, n_vec or n_use, b_in)[2]
        results[name] = mx
        if grid.rank == 0:
            print(f"  sweep[{name}]: n={n_use} grid={grid.R}x{grid.C} "
                  f"resid_max={mx:.3e} {'ok' if mx < tol else 'FAIL'}",
                  flush=True)
    bad = {k: v for k, v in results.items() if not v < tol}
    if bad:
        raise AssertionError(f"grid sweep residuals above {tol}: {bad}")
    return results


def _dryrun_rank(rank: int, n_processes: int, device: str) -> None:
    from eigenkernel_tpu_torch.parallel import mesh as pm
    from eigenkernel_tpu_torch.solvers.api import fused_solver

    if device == "cuda":
        nccl = torch.distributed.get_backend() == "nccl"
        dev = torch.device("cuda", rank if nccl else 0)
    else:
        dev = torch.device("cpu")
    grid = pm.make_mesh(pm.layout_grid(n_processes), dev)
    n = 64
    while n % grid.R or n % grid.C:
        n *= 2
    # the two-stage generalized pipeline: the elpa reduction on the grid,
    # to_band on blocks, the chunked chase with the sweep-sharded store,
    # the sharded back-transform and recovery
    fn = fused_solver("general_elpa2", n=n, mesh=grid, block_size=16)
    a, b = _example_pencil(n, np.float32)
    w, _ = fn(pm.distribute(a, grid, torch.float32),
              pm.distribute(b, grid, torch.float32))
    w = w.cpu().numpy()
    if not (w.shape == (n,) and np.isfinite(w).all()
            and (np.diff(w) >= -1e-4).all()):
        raise AssertionError(f"dryrun_multichip: eigenvalues not {n} "
                             f"finite ascending values: {w}")
    if rank == 0:
        print(f"dryrun_multichip ok: n_processes={n_processes} "
              f"grid=({grid.R}, {grid.C}) n={n} "
              f"backend={torch.distributed.get_backend()} device={dev} "
              f"lambda_range=({w[0]:.3f}, {w[-1]:.3f})", flush=True)
    if os.environ.get("EK_DRYRUN_SWEEP", "1") != "0":
        sweep_solvers_on_grid(grid, int(os.environ.get("EK_DRYRUN_N", "256")),
                              n_two=int(os.environ.get("EK_DRYRUN_N2",
                                                       "512")))


def dryrun_multichip(n_processes: int, device: str = "cuda",
                     timeout: float = 1800.0) -> None:
    """Run the distributed generalized solve, then the registry sweep, on
    ``n_processes`` ranks of this host: NCCL with card ``rank`` each where
    ``device`` is ``cuda`` and there are that many cards, else gloo (all
    ranks on card 0, or on the CPU for ``device="cpu"``)."""
    from eigenkernel_tpu_torch.parallel import multihost

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA device; pass "
                           "device='cpu' to run on the CPU")
    nccl = device == "cuda" and torch.cuda.device_count() >= n_processes
    multihost.run_ranks(_dryrun_rank, n_processes, n_processes, device,
                        backend="nccl" if nccl else "gloo", timeout=timeout)


def main(argv) -> int:
    device = "cpu" if argv[-2:] == ["--platform", "cpu"] else "cuda"
    args = argv[:-2] if device == "cpu" else argv
    dryrun_multichip(int(args[0]) if args else 4, device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
