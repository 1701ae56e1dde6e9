"""The port's process grid against the JAX package's mesh.

Grid solves run in spawned gloo ranks on 127.0.0.1
(``torch_mesh_ranks.py``), one thread each, with a join timeout; the JAX
package solves the same float64 numpy matrices on a 2 x 2 mesh of the
conftest's virtual CPU devices.  The modules run on a 2 x 2 grid on their
own: ``tridiagonalize`` (Q T Q^T = A), ``tridiag_dc`` with its top merges
sharded, and the selecting core, whose eigenvalues and first shifted
solve must equal the single-device port's bit for bit (the plain B1 and
B2 on the CPU).
"""

import io

import jax
import numpy as np
import pytest
import scipy.linalg as sla
import torch

import torch_mesh_ranks as ranks
from eigenkernel_tpu.parallel import mesh as jax_mesh
from eigenkernel_tpu.solvers.api import solve as jax_solve
from eigenkernel_tpu_torch.ops import dc, householder, tridiag, tridiag_solve
from eigenkernel_tpu_torch.ops.blocked import gershgorin_sentinel
from eigenkernel_tpu_torch.parallel import mesh as pm

# (tag, solver, n_vec, n, seed): a ragged pad on the 1 x 4 grid (130)
CASES = [("scalapack", "scalapack", None, 130, 21),
         ("select", "scalapack_select", 20, 200, 22),
         ("lapack", "lapack", None, 64, 23)]
# float64 / float32: eigenvalues (times ||A||_2), residual, orthogonality
BARS = {"float64": (1e-12, 1e-12, 1e-10), "float32": (1e-4, 1e-5, 1e-3)}
# (n, block): one WY group on rank 0; two groups (512 + 88 columns), on
# ranks 0 and 1
TRI_CASES = [(130, 16), (600, 64)]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _sym(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    return (a + a.T) / 2


def _load(out_dir, world):
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def grid_solves(tmp_path_factory):
    """Every case in both dtypes on a 2 x 2 and a 1 x 4 grid: rank 0's
    results, by grid."""
    cases = [(f"{tag}-{dt}", solver, k, dt, _sym(n, seed).astype(dt))
             for tag, solver, k, n, seed in CASES
             for dt in ("float64", "float32")]
    out = {}
    for shape in ((2, 2), (1, 4)):
        d = tmp_path_factory.mktemp(f"grid{shape[0]}x{shape[1]}")
        ranks.run_ranks("solve_cases", 4, shape, cases, str(d))
        out[shape] = _load(d, 4)[0]
    return out


@pytest.fixture(scope="module")
def jax_solves():
    mesh = jax_mesh.make_mesh((2, 2), jax.devices()[:4])
    out = {}
    for tag, solver, k, n, seed in CASES:
        for dt in ("float64", "float32"):
            pairs = jax_solve(_sym(n, seed).astype(dt), solver=solver,
                              n_vec=k, mesh=mesh)
            out[f"{tag}-{dt}"] = np.asarray(pairs.values, np.float64)
    return out


@pytest.mark.parametrize("dt", ["float64", "float32"])
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("tag,solver,k,n,seed", CASES)
def test_grid_solve_matches_jax_mesh(grid_solves, jax_solves, shape, dt,
                                     tag, solver, k, n, seed):
    res = grid_solves[shape]
    key = f"{tag}-{dt}"
    a = _sym(n, seed).astype(dt).astype(np.float64)
    w, v = res[f"{key}/w"].astype(np.float64), res[f"{key}/v"]
    v = v.astype(np.float64)
    kk = n if k is None else k
    assert w.shape == (kk,) and v.shape == (n, kk)
    ev_bar, resid_bar, orth_bar = BARS[dt]
    norm2 = np.abs(np.linalg.eigvalsh(a)).max()
    assert np.abs(w - jax_solves[key]).max() <= ev_bar * norm2
    resid = np.linalg.norm(a @ v - v * w, axis=0).max() / np.linalg.norm(a)
    g = v.T @ v
    dg = np.sqrt(np.diag(g))
    gs = g / np.outer(dg, dg) - np.eye(kk)
    assert resid <= resid_bar
    assert np.linalg.norm(gs) <= orth_bar
    # the grid verifier's numbers are the same numbers
    ave, mx, orth = res[f"{key}/check"]
    assert mx <= resid_bar and orth <= orth_bar
    assert abs(mx - resid) <= 0.1 * resid + 1e-15
    assert ave <= mx
    s2 = (v * v).sum(axis=0)
    ipr = (v ** 4).sum(axis=0) / (s2 * s2)
    np.testing.assert_allclose(res[f"{key}/ipr"], ipr,
                               rtol=1e-10 if dt == "float64" else 1e-4)


@pytest.fixture(scope="module")
def modules(tmp_path_factory):
    rng = np.random.default_rng(31)
    coo_n = 31                          # padded to 32 on 2 x 2
    a = _sym(coo_n, 32)
    a[np.abs(a) < 0.8] = 0.0
    i, j = np.tril_indices(coo_n)
    keep = a[i, j] != 0
    inputs = {"tri": [(_sym(n, 33 + c), block)
                      for c, (n, block) in enumerate(TRI_CASES)],
              "dc_d": rng.standard_normal(256),
              "dc_e": rng.standard_normal(255),
              "sel_d": rng.standard_normal(200),
              "sel_e": rng.standard_normal(199), "sel_k": 20,
              "coo": (i[keep], j[keep], a[i, j][keep]), "coo_n": coo_n,
              "coo_dense": a}
    d = tmp_path_factory.mktemp("modules")
    ranks.run_ranks("module_checks", 4, (2, 2), inputs, str(d))
    return inputs, _load(d, 4)


@pytest.mark.parametrize("case", range(len(TRI_CASES)))
def test_tridiagonalize_on_grid(modules, case):
    inputs, res = modules
    a, block = inputs["tri"][case]
    n = a.shape[0]
    key = f"tri{case}"
    r = res[0]
    for other in res[1:]:               # whole and the same on every rank
        for f in ("d", "e", "taus", "Q"):
            assert np.array_equal(other[f"{key}/{f}"], r[f"{key}/{f}"])
    # WY group i on rank i mod 4 only
    groups = householder.wy_groups(n, block)
    for rank, other in enumerate(res):
        assert other[f"{key}/groups"].tolist() == [
            i for i in range(len(groups)) if i % 4 == rank]
    v = torch.tensor(sum(other[f"{key}/V_part"] for other in res))
    d, e = torch.tensor(r[f"{key}/d"]), torch.tensor(r[f"{key}/e"])
    eye = torch.eye(n, dtype=torch.float64)
    q_one = householder.apply_wy(v, torch.tensor(r[f"{key}/taus"]), eye,
                                 block)
    q = torch.tensor(r[f"{key}/Q"])
    assert float((q - q_one).abs().max()) <= 1e-14
    t = householder.tridiag_matrix(d, e)
    assert float((q @ t @ q.T - torch.tensor(a)).abs().max()) <= 1e-12
    one = householder.tridiagonalize(torch.tensor(a), block)
    w_grid = np.linalg.eigvalsh(t.numpy())
    w_one = np.linalg.eigvalsh(householder.tridiag_matrix(one.d,
                                                          one.e).numpy())
    assert np.abs(w_grid - w_one).max() <= 1e-12 * np.abs(w_one).max()


def test_tridiag_dc_on_grid(modules):
    inputs, res = modules
    r = res[0]
    assert r["dc/sharded"].tolist() == [True, True]   # both levels of 256
    d, e = inputs["dc_d"], inputs["dc_e"]
    ref = sla.eigh_tridiagonal(d, e, eigvals_only=True)
    w, v = r["dc/w"], r["dc/v"]
    w_one, _ = dc.tridiag_dc(torch.tensor(d), torch.tensor(e))
    span = np.abs(ref).max()
    assert np.abs(w - ref).max() <= 5e-13 * span
    assert np.abs(w - w_one.numpy()).max() <= 5e-13 * span
    t = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    assert np.linalg.norm(t @ v - v * w, axis=0).max() <= 5e-13 * span
    assert np.abs(v.T @ v - np.eye(256)).max() <= 1e-12


def test_selecting_core_bit_for_bit(modules):
    inputs, res = modules
    d, e = torch.tensor(inputs["sel_d"]), torch.tensor(inputs["sel_e"])
    k = inputs["sel_k"]
    first = []
    solve_fn = tridiag_solve.tridiag_solve

    def first_solve(*args):
        x = solve_fn(*args)
        if not first:
            first.append(x.clone())
        return x

    tridiag_solve.tridiag_solve = first_solve
    try:
        lam, vec = tridiag.tridiag_eigh(d, e, k)
    finally:
        tridiag_solve.tridiag_solve = solve_fn
    for r in res:
        j0, j1 = r["sel/lanes"]
        assert j1 > j0
        assert np.array_equal(r["sel/lam"], lam.numpy())
        assert np.array_equal(r["sel/first"], first[0][:, j0:j1].numpy())
    w, v = res[0]["sel/w"], res[0]["sel/v"]
    t = householder.tridiag_matrix(d, e).numpy()
    span = float(np.abs(lam.numpy()).max())
    assert np.linalg.norm(t @ v - v * w, axis=0).max() <= 1e-12 * span
    assert np.abs(v.T @ v - np.eye(k)).max() <= 1e-12
    # after the normalizations and cholqr2, to tolerance only
    assert np.abs(np.abs(v) - np.abs(vec.numpy())).max() <= 1e-10


def test_distribute_coo_blocks(modules):
    inputs, res = modules
    n = inputs["coo_n"]
    dense = np.zeros((32, 32))
    dense[:n, :n] = inputs["coo_dense"]
    for r in res:
        r0, c0, n_m = r["coo/at"]
        assert n_m == 32
        blk = r["coo/block"]
        assert np.array_equal(blk, dense[r0:r0 + blk.shape[0],
                                         c0:c0 + blk.shape[1]])
        mu = float(gershgorin_sentinel(torch.tensor(inputs["coo_dense"])))
        assert abs(float(r["coo/sentinel"]) - mu) <= 1e-13 * abs(mu)


@pytest.mark.parametrize("n_procs", range(1, 13))
def test_layout_grid_matches_jax(n_procs):
    assert pm.layout_grid(n_procs) == jax_mesh.layout_grid(n_procs)


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (1, 4), (2, 4), (1, 3)])
def test_padded_dim_and_grid_mapping_match_jax(shape):
    r, c = shape
    jm = jax_mesh.make_mesh(shape, jax.devices()[:r * c])
    grid = pm.ProcessGrid(R=r, C=c, rank=0, device=torch.device("cpu"))
    for n in (1, 30, 64, 65, 130, 131):
        # the port's ops take any n: no panel multiple (JAX block 1)
        assert pm.padded_dim(n, grid) == jax_mesh.padded_dim(n, jm, 1)
    got, want = io.StringIO(), io.StringIO()
    pm.print_grid_mapping(grid, file=got)
    jax_mesh.print_grid_mapping(jm, file=want)
    assert got.getvalue() == want.getvalue()
