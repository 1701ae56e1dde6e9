"""The model flops the two packages log for each stage of a solve.

``log.json`` carries every stage's model rate as ``!<stage>_Gflops``, the
stage's model flops over its seconds.  The seconds differ between runs,
so this holds the model flops themselves: each package's
``SolverContext.tick`` is wrapped to record the count it is handed.  The
counts are the same formulas, so they must be equal exactly, for the
full spectrum (divide and conquer's model, whichever tridiagonal core
ran) and for a part of it (bisection and inverse iteration's), on both
SEP cores.  n is a multiple of the panel width, so the JAX package does
not pad.
"""

import numpy as np
import pytest
import torch

from eigenkernel_tpu.solvers import pipelines as jax_pipelines
from eigenkernel_tpu.solvers.api import solve as jax_solve
from eigenkernel_tpu_torch.obs import flops as fl
from eigenkernel_tpu_torch.solvers import pipelines
from eigenkernel_tpu_torch.solvers.api import solve

N = 128


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _model_flops(monkeypatch, ctx_cls, run):
    seen = {}

    def tick(self, name, t0, *args, flops=None):
        seen[name] = flops

    with monkeypatch.context() as patch:
        patch.setattr(ctx_cls, "tick", tick)
        run()
    return seen


@pytest.mark.parametrize("core,solver,k,tridiag", [
    ("one_stage", "scalapack", None, "auto"),
    ("one_stage", "scalapack", None, "bisect"),
    ("two_stage", "eigensx", None, "bisect"),
    ("one_stage", "scalapack_select", 20, "auto"),
    ("two_stage", "scalapack_select", 20, "auto"),
])
def test_stage_flops_equal_jax(monkeypatch, core, solver, k, tridiag):
    rng = np.random.default_rng(2)
    a = rng.standard_normal((N, N))
    a = (a + a.T) / 2
    for var, val in (("EK_TRIDIAG", tridiag), ("EK_SELECT_CORE", core)):
        monkeypatch.setenv(var, val)
    got = _model_flops(monkeypatch, pipelines.SolverContext,
                       lambda: solve(torch.tensor(a), solver=solver,
                                     n_vec=k))
    ref = _model_flops(monkeypatch, jax_pipelines.SolverContext,
                       lambda: jax_solve(a, solver=solver, n_vec=k))
    assert got == ref
    kk = N if k is None else k
    assert got["sep:tridiag_eigh"] == (fl.tridiag_dc(N) if k is None
                                       else fl.bisect_invit(N, kk))


@pytest.mark.parametrize("solver,stage,model", [
    ("jacobi", "sep:jacobi", fl.jacobi),
    ("qdwh_dc", "sep:qdwh_dc", fl.qdwh_dc),
])
def test_extra_core_flops_equal_jax(monkeypatch, solver, stage, model):
    # the panel only sets the Jacobi block: 32 keeps the plain pair eigh
    # short, and N stays a multiple of it, so the JAX package does not pad
    a = np.random.default_rng(4).standard_normal((N, N))
    a = (a + a.T) / 2
    got = _model_flops(monkeypatch, pipelines.SolverContext,
                       lambda: solve(torch.tensor(a), solver=solver,
                                     block_size=32))
    ref = _model_flops(monkeypatch, jax_pipelines.SolverContext,
                       lambda: jax_solve(a, solver=solver, block_size=32))
    assert got == ref == {stage: model(N)}


@pytest.mark.parametrize("solver,reduce", [
    ("general_elpa1", "solve:reduce_elpa"),
    ("general_scalapacknew_eigens", "reduce_generalized_new"),
    ("general_scalapack_eigensx", "reduce_generalized"),
    ("general_eigh", "solve:reduce_elpa"),
])
def test_generalized_stage_flops_equal_jax(monkeypatch, solver, reduce):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((N, N))
    a = (a + a.T) / 2
    m = rng.standard_normal((N, N))
    b = m @ m.T / N + np.eye(N)
    monkeypatch.delenv("EK_TRIDIAG", raising=False)
    got = _model_flops(monkeypatch, pipelines.SolverContext,
                       lambda: solve(torch.tensor(a), torch.tensor(b),
                                     solver=solver))
    ref = _model_flops(monkeypatch, jax_pipelines.SolverContext,
                       lambda: jax_solve(a, b, solver=solver))
    assert got == ref
    assert reduce in got and "recovery_generalized" in got
