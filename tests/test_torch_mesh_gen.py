"""The port's generalized names and two-stage core on a process grid
against the JAX package's mesh (the modules on their own:
``test_torch_mesh_gen_ops.py``).

Grid solves run in spawned gloo ranks on 127.0.0.1
(``torch_mesh_ranks.py``), one thread each, with a join timeout, on a
2 x 2 and a 1 x 4 grid at n = 131 (padded to 132); the JAX package
solves the same float64 / float32 numpy matrices on a 2 x 2 mesh of the
conftest's virtual CPU devices.  Each solve is held to the JAX mesh's
eigenvalues and scipy's, the residual and orthogonality bars in the B
metric, and the grid verifier's own numbers.
"""

import jax
import numpy as np
import pytest
import scipy.linalg as sla
import torch

import torch_mesh_ranks as ranks
from eigenkernel_tpu.parallel import mesh as jax_mesh
from eigenkernel_tpu.solvers.api import solve as jax_solve

# (tag, solver, n_vec, generalized, env): the eleven general_* names with
# a grid core, eigensx, eigh, general_auto and the two-stage selecting
# core; the back-transform variants are held against the JAX package's
# eigensx (the blocked schedule on a mesh), general_auto against its pick
CASES = [
    ("gen_scalapack", "general_scalapack", None, True, {}),
    ("gen_new", "general_scalapacknew_eigens", None, True, {}),
    ("gen_elpa1", "general_elpa1", None, True, {}),
    ("gen_eigh", "general_eigh", None, True, {}),
    ("gen_select", "general_scalapack_select", 20, True, {}),
    ("eigensx", "eigensx", None, False, {}),
    ("gen_elpa2", "general_elpa2", None, True, {}),
    ("gen_elpa_sx", "general_elpa_eigensx", None, True, {}),
    ("gen_scalapack_sx", "general_scalapack_eigensx", None, True, {}),
    ("gen_scalapack_s", "general_scalapack_eigens", None, True, {}),
    ("gen_elpa_scalapack", "general_elpa_scalapack", None, True, {}),
    ("gen_elpa_s", "general_elpa_eigens", None, True, {}),
    ("eigh", "eigh", None, False, {}),
    ("gen_auto", "general_auto", None, True, {}),
    ("select_2s", "scalapack_select", 20, False,
     {"EK_SELECT_CORE": "two_stage"}),
    ("bt_blocked", "eigensx", None, False, {"EK_BACKTRANSFORM": "blocked"}),
    ("bt_wf", "eigensx", None, False, {"EK_BACKTRANSFORM": "wf_pallas"}),
    ("bt_pallas", "eigensx", None, False, {"EK_BACKTRANSFORM": "pallas"}),
]
JAX_OF = {"bt_blocked": "eigensx", "bt_wf": "eigensx", "bt_pallas": "eigensx",
          "gen_auto": "gen_new"}
N_SOLVE = 131                # padded to 132 on both grids
SHAPES = [(2, 2), (1, 4)]
DTYPES = ["float64", "float32"]
# float64 / float32: eigenvalues (times ||A||_2), residual, orthogonality
BARS = {"float64": (1e-12, 1e-12, 1e-10), "float32": (1e-4, 1e-5, 1e-3)}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _pencil(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    m = rng.standard_normal((n, n))
    return (a + a.T) / 2, m @ m.T / n + np.eye(n)


def _load(out_dir, world):
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def grid_solves(tmp_path_factory):
    """Every case in both dtypes on each grid: rank 0's results."""
    a, b = _pencil(N_SOLVE, 51)
    cases = [(f"{tag}-{dt}", solver, k, dt, a.astype(dt),
              b.astype(dt) if gen else None, env)
             for tag, solver, k, gen, env in CASES for dt in DTYPES]
    out = {}
    for shape in SHAPES:
        d = tmp_path_factory.mktemp(f"gen{shape[0]}x{shape[1]}")
        ranks.run_ranks("solve_cases", 4, shape, cases, str(d), timeout=300)
        out[shape] = _load(d, 4)[0]
    return out


@pytest.fixture(scope="module")
def jax_solves():
    mesh = jax_mesh.make_mesh((2, 2), jax.devices()[:4])
    a, b = _pencil(N_SOLVE, 51)
    out = {}
    for tag, solver, k, gen, env in CASES:
        if tag in JAX_OF:
            continue
        with ranks._env(env):
            for dt in DTYPES:
                pairs = jax_solve(a.astype(dt), b.astype(dt) if gen else None,
                                  solver=solver, n_vec=k, mesh=mesh)
                out[f"{tag}-{dt}"] = np.asarray(pairs.values, np.float64)
    return out


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("tag,solver,k,gen,env", CASES)
def test_grid_solve_matches_jax_mesh(grid_solves, jax_solves, shape, dt,
                                     tag, solver, k, gen, env):
    res = grid_solves[shape]
    key = f"{tag}-{dt}"
    a, b = _pencil(N_SOLVE, 51)
    a = a.astype(dt).astype(np.float64)
    b = b.astype(dt).astype(np.float64) if gen else np.eye(N_SOLVE)
    w, v = res[f"{key}/w"].astype(np.float64), res[f"{key}/v"]
    v = v.astype(np.float64)
    kk = N_SOLVE if k is None else k
    assert w.shape == (kk,) and v.shape == (N_SOLVE, kk)
    ev_bar, resid_bar, orth_bar = BARS[dt]
    ref = sla.eigh(a, b, eigvals_only=True)[:kk]
    norm2 = np.abs(np.linalg.eigvalsh(a)).max()
    jax_w = jax_solves[f"{JAX_OF.get(tag, tag)}-{dt}"]
    assert np.abs(w - jax_w).max() <= ev_bar * norm2
    assert np.abs(w - ref).max() <= ev_bar * norm2
    bv = b @ v
    resid = np.linalg.norm(a @ v - bv * w, axis=0).max() / np.linalg.norm(a)
    g = v.T @ bv
    dg = np.sqrt(np.diag(g))
    gs = g / np.outer(dg, dg) - np.eye(kk)
    assert resid <= resid_bar
    assert np.linalg.norm(gs) <= orth_bar
    # B-orthonormal as they come (the dsygv convention)
    assert np.abs(np.diag(g) - 1).max() <= orth_bar
    # the grid verifier's numbers (B metric) are the same numbers
    ave, mx, orth = res[f"{key}/check"]
    assert mx <= resid_bar and orth <= orth_bar
    assert abs(mx - resid) <= 0.1 * resid + 1e-15
    assert abs(orth - np.linalg.norm(gs)) <= 0.1 * orth + 1e-15
    assert ave <= mx
    s2 = (v * bv).sum(axis=0)
    ipr = (v ** 4).sum(axis=0) / (s2 * s2)
    np.testing.assert_allclose(res[f"{key}/ipr"], ipr,
                               rtol=1e-10 if dt == "float64" else 1e-4)
    if tag.startswith("bt_"):
        # the same vectors as the default schedule's, up to rounding
        v0 = res[f"eigensx-{dt}/v"].astype(np.float64)
        assert np.abs(v - v0).max() <= (1e-10 if dt == "float64" else 1e-3)
