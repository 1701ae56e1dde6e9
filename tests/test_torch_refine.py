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

from ekbench import data, reference
from eigenkernel_tpu.ops import refine as jax_refine
from eigenkernel_tpu.solvers.api import solve as jax_solve
from eigenkernel_tpu_torch.obs import events, mem
from eigenkernel_tpu_torch.obs.events import EventLog
from eigenkernel_tpu_torch.ops import refine
from eigenkernel_tpu_torch.solvers.api import solve

MIXED_CELL = "vcnt22500_gen_mixed.elpa2_full"


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
    # the cleanup's S = V^T A V: ascending diagonal, couplings ~1e-9
    # (generic), or with clusters of two neighbours split by 1e-6 and
    # coupled as strongly.  The port solves windows of S by eigh where the
    # JAX package runs adjacent-pair Jacobi passes, so J is another basis
    # of each cluster (an eigh's vectors of a cluster are any of its
    # bases) and is held by what it does; the sorted diagonal of J^T S J
    # is the JAX one's to 1e-14.  A cluster of three or more members
    # coupled as strongly is left by the JAX passes at its coupling:
    # test_cleanup_resolves_a_coupling_between_non_neighbours and
    # test_window_eigh_diagonalizes_clusters_whole hold the port there.
    k = 64
    mu = np.linspace(1, 2, k)
    s = np.diag(mu) + 1e-9 * _sym(k, 7)
    if kind == "clusters":
        pairs = np.kron(np.eye(k // 2), np.ones((2, 2)))
        s = np.diag(np.repeat(mu[::2], 2)) + 1e-6 * _sym(k, 6) * pairs \
            + 1e-9 * _sym(k, 7)
    lam, jb = refine._window_eigh(torch.tensor(s))
    j_p = refine._times_windows(torch.eye(k, dtype=torch.float64),
                                jb).numpy()
    s_p = j_p.T @ s @ j_p
    s_j, _ = (np.asarray(x) for x in jax_refine._adjacent_jacobi(s))
    assert np.abs(np.sort(np.diag(s_p)) - np.sort(np.diag(s_j))).max() \
        <= 1e-14
    assert np.abs(j_p.T @ j_p - np.eye(k)).max() <= 1e-14
    assert np.abs(np.diag(s_p) - lam.numpy()).max() <= 1e-14
    # the couplings that neither reaches (beyond a cluster, ~1e-9) are
    # left alike: the largest off-diagonals of the two J^T S J agree
    off_p, off_j = (np.abs(x - np.diag(np.diag(x))).max()
                    for x in (s_p, s_j))
    assert abs(off_p - off_j) <= 1e-14
    one = torch.tensor([[2.0]], dtype=torch.float64)
    lam1, jb1 = refine._window_eigh(one)
    j1 = refine._times_windows(torch.ones(1, 1, dtype=torch.float64), jb1)
    assert torch.equal(lam1, one[0]) and torch.equal(j1.abs(),
                                                     torch.ones(1, 1))


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


@pytest.mark.parametrize("n", [80, 256])
@pytest.mark.parametrize("dtype", ["mixed", "float32"])
def test_mixed_solve_meets_the_benchmark_cells_limits(n, dtype):
    # the benchmark's mixed cell at a small n: its configuration's
    # generators and seeded pencil, its solver, judged by its reference
    # under its limits; the same solve in float32 alone misses one
    cell = data.cell(MIXED_CELL)
    cfg = dict(data.config(cell["config"]), n=n)
    mats = data.make(cfg, 2 ** 31 + 17, "cpu")
    a, b = mats["a"], mats["b"]
    got = solve(a, b, solver=cell["solver"], n_vec=cell["n_vec"],
                dtype=dtype)
    ref = reference.eigenvalues(a, b)
    nums = reference.judge(a, b, ref, n, [got.values], [],
                           torch.arange(0), got.values, got.vectors)
    over = [key for key, limit in cell["limits"].items()
            if nums[key] > limit]
    assert bool(over) == (dtype == "float32"), nums


@pytest.mark.parametrize("steps", [None, 3])
def test_mixed_solve_records_refinement_spans_and_counters(monkeypatch,
                                                           steps):
    if steps is None:
        monkeypatch.delenv("EK_REFINE_STEPS", raising=False)
    else:
        monkeypatch.setenv("EK_REFINE_STEPS", str(steps))
    want = refine.STEPS if steps is None else steps
    n = 64
    log = EventLog(stream=False)
    solve(torch.tensor(_sym(n, 11)), torch.tensor(_spd(n, 12)),
          solver="general_elpa2", dtype="mixed", log=log)
    ev = {e["name"]: e for e in log.events()}
    assert ev["solve:refine"]["num_repeated"] == 1
    assert ev["refine:step"]["num_repeated"] == want
    assert ev["refine:start"]["num_repeated"] == 1
    assert ev["refine:cleanup"]["num_repeated"] == 1
    assert (ev["refine:steps"]["num_repeated"],
            ev["refine:steps"]["val"]) == (1, want)
    assert ev["refine:clustered"]["num_repeated"] == 1
    assert 0 <= ev["refine:clustered"]["val"] <= n - 1
    assert ev["wait:refine_clustered"]["num_repeated"] == 1
    parents = {sp.name: sp.parent for sp in log.spans()}
    assert parents["refine:start"] == "solve:refine"
    assert parents["refine:step"] == "solve:refine"
    assert parents["refine:cleanup"] == "solve:refine"
    assert parents["wait:refine_clustered"] == "solve:refine"


def _degenerate(n, seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((n, n)))
    lam = np.concatenate([np.full(30, 1.0), np.linspace(2, 3, n - 30)])
    return (q * lam) @ q.T


@pytest.mark.parametrize("case,want", [("generic", 0), ("degenerate", 29)])
def test_clustered_counts_the_pairs_left_to_the_cleanup(case, want):
    # a 30-fold eigenvalue leaves its 29 neighbouring pairs under the
    # threshold; the generic matrix's gaps are far above it
    n = 150
    a = _sym(n, 1) if case == "generic" else _degenerate(n, 3)
    v32 = np.linalg.eigh(a.astype(np.float32))[1]
    log = EventLog(stream=False)
    with events.stage("refine", log):
        refine.refine_eigenpairs(torch.tensor(a), torch.tensor(v32))
    ev = {e["name"]: e["val"] for e in log.events()}
    assert (ev["refine:steps"], ev["refine:clustered"]) == (refine.STEPS,
                                                            want)


@pytest.mark.parametrize("traced", [False, True])
def test_refinement_reads_the_device_only_when_traced(monkeypatch, traced):
    # without a log the refinement makes no host read of a device value
    # (no synchronize in the timed solve); with one, the clustered count
    # is its one read
    reads = []
    for name in ("__bool__", "__float__", "__int__", "__index__", "item",
                 "tolist"):
        real = getattr(torch.Tensor, name)

        def spy(self, *args, _real=real, _name=name):
            reads.append(_name)
            return _real(self, *args)

        monkeypatch.setattr(torch.Tensor, name, spy)
    a = _sym(60, 13)
    v32 = np.linalg.eigh(a.astype(np.float32))[1]
    a, v32 = torch.tensor(a), torch.tensor(v32)
    log = EventLog(stream=False) if traced else None
    with events.stage("refine", log):
        refine.refine_eigenpairs(a, v32, steps=2)
    assert reads == (["__int__"] if traced else [])
    assert events.active() is False


@pytest.mark.parametrize("active", [False, True])
def test_counters_count_into_the_active_log_alone(active):
    log = EventLog(stream=False)
    with events.stage("outer", log if active else None):
        assert events.active() is active
        events.count("c", 2)
        events.count("c", 3)
    ev = {e["name"]: e for e in log.events()}
    if active:
        assert (ev["c"]["num_repeated"], ev["c"]["val"]) == (2, 5.0)
    else:
        assert ev == {}


def _stuck_triple(n=120, seed=21):
    """A matrix with a cluster of three (gaps 2e-7, far below the
    threshold's floor) and a float32 start whose cluster columns x, y, z
    (neighbours in that order) mix x and z alone: the one coupling of the
    cluster sits between two members that are not neighbours."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    mu = np.linspace(-1.0, 1.0, n)
    c = n // 2
    mu[c:c + 3] = mu[c] + np.array([0.0, 2e-7, 4e-7])
    a = (q * mu) @ q.T
    v = q.copy()
    cs, sn = np.cos(0.3), np.sin(0.3)
    v[:, c], v[:, c + 2] = cs * q[:, c] - sn * q[:, c + 2], \
        sn * q[:, c] + cs * q[:, c + 2]
    return (a + a.T) / 2, v.astype(np.float32), mu


def test_cleanup_resolves_a_coupling_between_non_neighbours():
    # the JAX package's adjacent-pair passes never rotate x and z (the
    # pairs (x, y) and (y, z) are uncoupled), so its residual stays at the
    # coupling's; the port's window eigh solves the cluster whole
    a, v32, mu = _stuck_triple()
    w, v = (x.numpy() for x in refine.refine_eigenpairs(
        torch.tensor(a), torch.tensor(v32)))
    w_j, v_j = (np.asarray(x) for x in jax_refine.refine_eigenpairs(
        a, v32))

    def resid(w, v):
        return np.abs(a @ v - v * w).max() / np.linalg.norm(a)

    assert resid(w_j, v_j) > 1e-9
    assert resid(w, v) <= 1e-14
    assert np.abs(w - mu).max() <= 1e-14
    assert np.abs(v.T @ v - np.eye(len(w))).max() <= 1e-13


@pytest.mark.parametrize("k", [1, 2, 3, 17, 131, 300, 1100])
def test_window_eigh_diagonalizes_clusters_whole(k):
    # S of clusters of W / 2 + 1 members (rotated within themselves,
    # couplings O(1) of their gaps) in ascending order: J is orthogonal,
    # J^T S J diagonal and its diagonal S's eigenvalues
    rng = np.random.default_rng(k)
    size = refine._window(k) // 2 + 1
    mu = np.sort(rng.standard_normal(k))
    s = np.diag(mu)
    for c in range(0, k, size):
        m = min(size, k - c)
        mu[c:c + m] = mu[c] + 1e-9 * np.sort(rng.random(m))
        qq, _ = np.linalg.qr(rng.standard_normal((m, m)))
        s[c:c + m, c:c + m] = (qq * mu[c:c + m]) @ qq.T
    s = torch.tensor((s + s.T) / 2)
    lam, jb = refine._window_eigh(s)
    j = refine._times_windows(torch.eye(k, dtype=s.dtype), jb)
    eye = torch.eye(k, dtype=s.dtype)
    assert (j.T @ j - eye).abs().max() <= 1e-14
    assert (j.T @ s @ j - torch.diag(lam)).abs().max() <= 1e-14
    assert (torch.sort(lam).values - torch.linalg.eigvalsh(s)).abs().max() \
        <= 1e-14
