"""The port's mixed-precision refinement (``ops/refine.py``) and
``dtype='mixed'`` against the JAX package's, with the cases and
tolerances of ``tests/test_refine.py``: float32 eigenvectors refined
against the float64 matrix, the two packages' eigenvalues to 1e-12 and,
where the whole spectrum is refined, the residual to 1e-14 of ||A||_F
(1e-13 for a generalized problem); the degenerate case is a 30-fold
cluster, the last one k = 2 vectors (the adjacent-pair pass of parity 1
has no pair).
"""

import numpy as np
import pytest
import scipy.linalg as sla
import torch

from eigenkernel_tpu.ops import refine as jax_refine
from eigenkernel_tpu.solvers.api import solve as jax_solve
from eigenkernel_tpu_torch.obs import mem
from eigenkernel_tpu_torch.ops import refine
from eigenkernel_tpu_torch.solvers.api import solve


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _sym(n, seed):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return (a + a.T) / 2


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (q * np.geomspace(1.0, 100.0, n)) @ q.T


@pytest.mark.parametrize("case", ["standard", "generalized", "degenerate",
                                  "two"])
def test_refine_matches_jax(case):
    n = 150
    a, b = _sym(n, 1), None
    if case == "generalized":
        b = _spd(n, 2)
        v32 = sla.eigh(a.astype(np.float32), b.astype(np.float32))[1]
    elif case == "degenerate":
        rng = np.random.default_rng(3)
        q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        lam = np.concatenate([np.full(30, 1.0), np.linspace(2, 3, n - 30)])
        a = (q * lam) @ q.T
    if b is None:
        v32 = np.linalg.eigh(a.astype(np.float32))[1]
    if case == "two":
        v32 = v32[:, :2]
    k = v32.shape[1]
    w, v = (x.numpy() for x in refine.refine_eigenpairs(
        torch.tensor(a), torch.tensor(v32),
        None if b is None else torch.tensor(b)))
    w_j, _ = jax_refine.refine_eigenpairs(a, v32, b=b)
    assert w.dtype == np.float64 and v.shape == (n, k)
    assert np.abs(w - np.asarray(w_j)).max() <= 1e-12
    w_ref = sla.eigh(a, b, eigvals_only=True)[:k]
    assert np.abs(w - w_ref).max() <= 1e-11
    bv = v if b is None else b @ v
    assert np.abs(v.T @ bv - np.eye(k)).max() <= 1e-11
    if k == n:
        # a part of the spectrum is refined only inside span(v): its
        # residual stays at the float32 start's, as in the JAX package
        bar = 1e-14 if b is None else 1e-13
        assert np.abs(a @ v - bv * w).max() / np.linalg.norm(a) <= bar


def test_refine_steps_from_the_environment(monkeypatch):
    a = _sym(60, 4)
    v32 = np.linalg.eigh(a.astype(np.float32))[1]
    monkeypatch.setenv("EK_REFINE_STEPS", "0")
    got = refine.refine_eigenpairs(torch.tensor(a), torch.tensor(v32))
    want = refine.refine_eigenpairs(torch.tensor(a), torch.tensor(v32),
                                    steps=0)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    # no Newton step: the cleanup alone leaves the float32 residual
    r = np.abs(a @ got[1].numpy() - got[1].numpy() * got[0].numpy()).max()
    assert r > 1e-10


@pytest.mark.parametrize("kind", ["generic", "clusters"])
def test_adjacent_jacobi_matches_jax(kind):
    k = 64
    s = _sym(k, 6)
    if kind == "clusters":
        # 4-fold clusters split by 1e-6: the angles are ill-conditioned
        # (tau ~ 1e-6 / 1e-6), so J is held by what it does, s to 1e-14
        s = np.diag(np.repeat(np.linspace(1, 2, k // 4), 4)) + 1e-6 * s
    s_p, j_p = (x.numpy() for x in refine._adjacent_jacobi(torch.tensor(s)))
    s_j, j_j = (np.asarray(x) for x in jax_refine._adjacent_jacobi(s))
    assert np.abs(s_p - s_j).max() <= 1e-14
    if kind == "generic":
        assert np.abs(j_p - j_j).max() <= 1e-14
    assert np.abs(j_p.T @ j_p - np.eye(k)).max() <= 1e-14
    assert np.abs(j_p.T @ s @ j_p - s_p).max() <= 1e-14
    one = torch.tensor([[2.0]])
    s1, j1 = refine._adjacent_jacobi(one)
    assert torch.equal(s1, one) and torch.equal(j1, torch.ones(1, 1))


@pytest.mark.parametrize("solver", ["scalapack", "general_elpa2"])
def test_solve_mixed_matches_jax(monkeypatch, solver):
    monkeypatch.delenv("EK_TRIDIAG", raising=False)
    n = 96
    a = _sym(n, 7)
    b = _spd(n, 8) if solver.startswith("general") else None
    ref = jax_solve(a, b, solver=solver, dtype="mixed")
    got = solve(torch.tensor(a), None if b is None else torch.tensor(b),
                solver=solver, dtype="mixed")
    assert got.values.dtype == torch.float64
    assert got.vectors.dtype == torch.float64
    w, v = got.values.numpy(), got.vectors.numpy()
    assert np.abs(w - np.asarray(ref.values)).max() <= 1e-11
    assert np.abs(w - sla.eigh(a, b, eigvals_only=True)).max() <= 1e-11
    bv = v if b is None else b @ v
    assert np.abs(a @ v - bv * w).max() / np.linalg.norm(a) <= 1e-13
    assert np.abs(v.T @ bv - np.eye(n)).max() <= 1e-11


def test_solve_mixed_refines_against_the_callers_matrix(monkeypatch):
    # the pipeline runs in float32; the refinement sees the caller's a in
    # float64 and the pipeline's vectors, and logs solve:refine after the
    # pipeline's stages
    from eigenkernel_tpu_torch.obs.events import EventLog
    from eigenkernel_tpu_torch.solvers import pipelines

    monkeypatch.delenv("EK_TRIDIAG", raising=False)
    seen = {}
    real = refine.refine_eigenpairs
    pipeline = pipelines.standard_pipeline

    def spy_pipeline(ctx, a_dev, *args):
        seen.update(pipeline=a_dev.dtype)
        return pipeline(ctx, a_dev, *args)

    monkeypatch.setattr(pipelines, "standard_pipeline", spy_pipeline)

    def spy(a64, v, b64=None):
        seen.update(a=a64.dtype, v=v.dtype, b=b64)
        return real(a64, v, b64)

    monkeypatch.setattr("eigenkernel_tpu_torch.solvers.api."
                        "refine_eigenpairs", spy)
    a = _sym(40, 9)
    log = EventLog(stream=False)
    solve(torch.tensor(a), solver="scalapack_select", n_vec=5,
          dtype="mixed", log=log)
    assert seen == {"pipeline": torch.float32, "a": torch.float64,
                    "v": torch.float64, "b": None}
    names = [e["name"] for e in log.events()]
    assert names[-1] == "solve:refine" and "sep:tridiagonalize" in names


def test_memstats_is_off_without_ek_mem_debug(monkeypatch):
    monkeypatch.delenv("EK_MEM_DEBUG", raising=False)
    assert mem.memstats("solve:pre_refine") is None
    monkeypatch.setenv("EK_MEM_DEBUG", "1")
    if not torch.cuda.is_available():
        assert mem.memstats("solve:pre_refine") is None
