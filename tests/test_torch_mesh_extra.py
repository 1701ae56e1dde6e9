"""The port's cores of slice 7d on a process grid against the JAX
package's mesh: ``jacobi``, ``general_jacobi``, ``qdwh_dc``,
``general_qdwh_dc`` and ``--dtype mixed`` on ``scalapack``, the two-stage
``scalapack_select`` and ``general_elpa2``.

Grid solves run in spawned gloo ranks on 127.0.0.1
(``torch_mesh_ranks.py``), one thread each, with a join timeout: a 2 x 2
and a 1 x 4 grid, both spawned at once by one module-scoped fixture while
the JAX package solves the same numpy matrices on a 2 x 2 mesh of the
conftest's virtual CPU devices (``EK_REFINE_STEPS`` pinned to 8 for both).
Sizes: n = 64 for the jacobi names (the plain pair eigh is a Python loop;
block 8, one tournament pair a rank), n = 131 for the rest (padded to 132;
the qdwh recursion's base at 16, so the grid splits the top block and a
child and the leaves split further on one device).  Each solve is held to
the JAX mesh's eigenvalues and scipy's, the residual and orthogonality
bars (B metric where generalized) and the grid verifier's own numbers; a
rank's largest tensor in the jacobi core and in the mixed refinement is
held to its share of the matrix.
"""

import concurrent.futures as cf

import jax
import numpy as np
import pytest
import scipy.linalg as sla
import torch

import torch_mesh_ranks as ranks
from eigenkernel_tpu.parallel import mesh as jax_mesh
from eigenkernel_tpu.solvers.api import solve as jax_solve
from eigenkernel_tpu_torch.ops import refine

N_JAC, N_REST = 64, 131
# (tag, solver, n_vec, generalized, n, env, options)
CASES = [
    ("jacobi", "jacobi", None, False, N_JAC, {}, {"block_size": 8}),
    ("gen_jacobi", "general_jacobi", None, True, N_JAC, {},
     {"block_size": 8}),
    ("qdwh", "qdwh_dc", None, False, N_REST, {}, {}),
    ("gen_qdwh", "general_qdwh_dc", None, True, N_REST, {}, {}),
    ("mixed", "scalapack", None, False, N_REST, {}, {}),
    ("mixed_select_2s", "scalapack_select", 20, False, N_REST,
     {"EK_SELECT_CORE": "two_stage"}, {}),
    ("mixed_elpa2", "general_elpa2", None, True, N_REST, {}, {}),
]
STEPS = {"EK_REFINE_STEPS": "8"}
SHAPES = [(2, 2), (1, 4)]
# float64 (and mixed) / float32: eigenvalues (times ||A||_2), residual,
# orthogonality
BARS = {"float64": (1e-12, 1e-12, 1e-10), "float32": (1e-4, 1e-5, 1e-3),
        "mixed": (1e-12, 1e-12, 1e-10)}
QDWH_BASE = 16


def _dtypes(tag):
    return ("mixed",) if tag.startswith("mixed") else ("float64", "float32")


KEYS = [(tag, dt) for tag, *_ in CASES for dt in _dtypes(tag)]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _pencil(n, seed=61):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    m = rng.standard_normal((n, n))
    return (a + a.T) / 2, m @ m.T / n + np.eye(n)


def _inputs(tag, dt):
    _, _, _, gen, n, _, _ = next(c for c in CASES if c[0] == tag)
    a, b = _pencil(n)
    np_dt = np.float64 if dt == "mixed" else dt
    return a.astype(np_dt), (b.astype(np_dt) if gen else None)


def _jax_solves():
    mesh = jax_mesh.make_mesh((2, 2), jax.devices()[:4])
    out = {}
    for tag, solver, k, gen, n, env, options in CASES:
        with ranks._env(dict(env, **STEPS)):
            for dt in _dtypes(tag):
                a, b = _inputs(tag, dt)
                pairs = jax_solve(a, b, solver=solver, n_vec=k, mesh=mesh,
                                  dtype="mixed" if dt == "mixed" else None,
                                  **options)
                out[(tag, dt)] = np.asarray(pairs.values, np.float64)
    return out


@pytest.fixture(scope="module")
def solves(tmp_path_factory):
    """Every case on both grids (all ranks' results) and on the JAX mesh:
    the two grids' ranks run while the JAX package solves."""
    cases = []
    for tag, solver, k, gen, n, env, options in CASES:
        for dt in _dtypes(tag):
            a, b = _inputs(tag, dt)
            cases.append((f"{tag}-{dt}", solver, k, dt, a, b,
                          dict(env, **STEPS), options))
    watch = ("jacobi-float64", "mixed-mixed")
    dirs = {shape: tmp_path_factory.mktemp(f"x{shape[0]}x{shape[1]}")
            for shape in SHAPES}
    with cf.ThreadPoolExecutor(len(SHAPES)) as pool:
        runs = [pool.submit(ranks.run_ranks, "extra_cases", 4, shape, cases,
                            str(dirs[shape]), QDWH_BASE, watch, timeout=300)
                for shape in SHAPES]
        jax_w = _jax_solves()
        for run in runs:
            run.result()
    grid = {shape: [dict(np.load(dirs[shape] / f"rank{r}.npz"))
                    for r in range(4)] for shape in SHAPES}
    return grid, jax_w


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("tag,dt", KEYS)
def test_grid_extra_core_matches_jax_mesh(solves, shape, tag, dt):
    grid, jax_w = solves
    res = grid[shape][0]
    _, solver, k, gen, n, _, _ = next(c for c in CASES if c[0] == tag)
    key = f"{tag}-{dt}"
    a, b = _inputs(tag, dt)
    a = a.astype(np.float64)
    b = b.astype(np.float64) if gen else np.eye(n)
    w, v = res[f"{key}/w"].astype(np.float64), res[f"{key}/v"]
    v = v.astype(np.float64)
    kk = n if k is None else k
    assert w.shape == (kk,) and v.shape == (n, kk)
    assert res[f"{key}/w"].dtype == (np.float32 if dt == "float32"
                                     else np.float64)
    ev_bar, resid_bar, orth_bar = BARS[dt]
    if tag == "mixed_select_2s":
        # a selecting run refines inside the span of its float32
        # vectors only: its residual stays float32-level, as the JAX
        # package's does (ROADMAP C)
        resid_bar = BARS["float32"][1]
    ref = sla.eigh(a, b, eigvals_only=True)[:kk]
    norm2 = np.abs(np.linalg.eigvalsh(a)).max()
    assert np.abs(w - jax_w[(tag, dt)]).max() <= ev_bar * norm2
    assert np.abs(w - ref).max() <= ev_bar * norm2
    bv = b @ v
    resid = np.linalg.norm(a @ v - bv * w, axis=0).max() / np.linalg.norm(a)
    g = v.T @ bv
    dg = np.sqrt(np.diag(g))
    gs = g / np.outer(dg, dg) - np.eye(kk)
    assert resid <= resid_bar
    assert np.linalg.norm(gs) <= orth_bar
    assert np.abs(np.diag(g) - 1).max() <= orth_bar
    # the grid verifier's numbers (B metric) are the same numbers
    ave, mx, orth = res[f"{key}/check"]
    assert mx <= resid_bar and orth <= orth_bar
    assert abs(mx - resid) <= 0.1 * resid + 1e-15
    assert abs(orth - np.linalg.norm(gs)) <= 0.1 * orth + 1e-15
    assert ave <= mx
    if tag.endswith("qdwh"):
        # the top block and a child split on the grid
        assert (res[f"{key}/splits"] > 0).sum() >= 2


@pytest.mark.parametrize("shape", SHAPES)
def test_grid_extra_cores_hold_a_share_of_the_matrix(solves, shape):
    # a rank's largest tensor: in the jacobi core at most big^2 / P words
    # (big: the core's padded dimension), in the mixed refinement at most
    # n_m words a column of a share (n_m^2 / P, or the widest share of
    # columns the float32 pipeline handed a rank: the streams hold a
    # rank's own share and one other): never the whole matrix
    res = solves[0][shape]
    n_m = 132
    widest = max(int(r["mixed-mixed/width"]) for r in res)
    for r, out in enumerate(res):
        big = int(out["jacobi-float64/big"])
        largest = int(out["jacobi-float64/largest"])
        assert 0 < largest <= big * big // 4 < N_JAC * N_JAC, (r, largest)
        largest = int(out["mixed-mixed/largest"])
        assert 0 < largest <= n_m * max(-(-n_m // 4), widest), (r, largest)
        assert largest < N_REST * N_REST


@pytest.mark.parametrize("k", [1, 2, 3, 40, 131])
def test_banded_cluster_cleanup_equals_the_dense_one(k, monkeypatch):
    # the grid cleanup's blocks of S, gathered from four ranks' columns,
    # and so its eigenvalues and J, are the one device's bit for bit
    # (clusters of three, couplings ~1e-9)
    rng = np.random.default_rng(k)
    q = rng.standard_normal((k, k)) * 1e-9
    s = torch.tensor(np.diag(np.repeat(np.arange(k), 3)[:k].astype(float))
                     + q + 0.9 * q.T)
    lam_dense, jb_dense = refine._window_eigh(s)
    win = refine._window(k)
    pairs = refine._pairs_index(k, win, s.device)

    def local(part, index, shape, grid):
        buf = torch.zeros(shape, dtype=part.dtype)
        buf[index] = part
        return buf

    monkeypatch.setattr(refine.pm, "gather_slots", local)
    g = sum(refine._gather_pairs(s[:, share], share, pairs, k, None)
            for share in torch.tensor(rng.permutation(k)).chunk(4))
    lam, jb = refine._window_passes(g, k, win)
    assert torch.equal(lam, lam_dense)
    assert torch.equal(jb, jb_dense)
