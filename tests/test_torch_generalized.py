"""The port's generalized problems against the JAX package: the ``blocked``
helpers, the three reductions and the recovery, every ``general_*`` name
through ``solve``, the B-metric verifier and the CLI with a B file.

Inputs are made with numpy from a seed: a random symmetric A and an SPD
B = M M^T / n + I.  Tolerances: the dense helpers and reductions are the
same arithmetic in another order, 1e-12 relative; the solves are held by
spectrum (1e-10 relative to scipy's and to the JAX solve's), B-residual
and B-orthogonality (within 10x the JAX solve's plus 1e-13: the JAX
package pads n to a panel multiple first, so its divide-and-conquer tree
differs, and that algorithm's residual moves with the tree, some 1e-14
relative to ||A||_F at n = 130 in both packages).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from eigenkernel_tpu.cli import main as jax_main
from eigenkernel_tpu.ops import blocked as jax_blocked
from eigenkernel_tpu.ops import reduction as jax_red
from eigenkernel_tpu.solvers.api import solve as jax_solve
from eigenkernel_tpu.verify import get_ipratios as jax_ipratios
from eigenkernel_tpu_torch import convert
from eigenkernel_tpu_torch.cli import main as port_main
from eigenkernel_tpu_torch.core.types import EigenPairs, SparseMatrix
from eigenkernel_tpu_torch.io.matrix_market import write_matrix
from eigenkernel_tpu_torch.ops import blocked, reduction
from eigenkernel_tpu_torch.solvers import pipelines, registry
from eigenkernel_tpu_torch.solvers.api import solve
from eigenkernel_tpu_torch.verify import (eval_orthogonality,
                                          eval_residual_norm, get_ipratios)

GENERAL = [name for name, s in registry.SOLVERS.items()
           if s.generalized and s.core not in ("jacobi", "qdwh")]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _pencil(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    m = rng.standard_normal((n, n))
    return (a + a.T) / 2, m @ m.T / n + np.eye(n)


def _rel(x, ref):
    return np.abs(np.asarray(x) - np.asarray(ref)).max() / \
        np.abs(np.asarray(ref)).max()


def test_eleven_generalized_names_run():
    assert len(GENERAL) == 11


def test_blocked_helpers_match_jax():
    n, blk = 96, 32
    a, b = _pencil(n, 1)
    l_j = np.asarray(jax_blocked.blocked_cholesky(jnp.asarray(b), block=blk))
    l = blocked.blocked_cholesky(torch.tensor(b)).numpy()
    assert _rel(l, l_j) <= 1e-12
    assert _rel(blocked.invert_lower_triangular(torch.tensor(l)).numpy(),
                jax_blocked.invert_lower_triangular(jnp.asarray(l),
                                                    block=blk)) <= 1e-12
    for tr in (False, True):
        assert _rel(blocked.trsm_lower(torch.tensor(l), torch.tensor(a),
                                       transpose=tr).numpy(),
                    jax_blocked.trsm_lower(jnp.asarray(l), jnp.asarray(a),
                                           transpose=tr, block=blk)) <= 1e-12
    assert _rel(blocked.trsm_right_lower_t(torch.tensor(l),
                                           torch.tensor(a)).numpy(),
                jax_blocked.trsm_right_lower_t(jnp.asarray(l), jnp.asarray(a),
                                               block=blk)) <= 1e-12
    g = np.random.default_rng(2).standard_normal((n, n))
    assert np.array_equal(blocked.symmetrize(torch.tensor(g)).numpy(),
                          np.asarray(jax_blocked.symmetrize(jnp.asarray(g))))


def test_cholesky_of_an_indefinite_b_raises():
    b = np.eye(5)
    b[3, 3] = -1.0
    with pytest.raises(blocked.NotPositiveDefiniteError):
        blocked.blocked_cholesky(torch.tensor(b))


@pytest.mark.parametrize("style", ["scalapack", "scalapack_new", "elpa"])
def test_reductions_and_recovery_match_jax(style):
    n, blk = 96, 32
    a, b = _pencil(n, 3)
    fn = {"scalapack": "reduce_scalapack",
          "scalapack_new": "reduce_scalapack_new",
          "elpa": "reduce_elpa"}[style]
    ref = getattr(jax_red, fn)(jnp.asarray(a), jnp.asarray(b), block=blk)
    got = getattr(reduction, fn)(torch.tensor(a), torch.tensor(b))
    assert got.style == ref.style
    assert _rel(got.a_std.numpy(), ref.a_std) <= 1e-12
    assert _rel(got.factor.numpy(), ref.factor) <= 1e-12
    y = np.random.default_rng(4).standard_normal((n, 7))
    x_ref = jax_red.recover(ref, jnp.asarray(y), block=blk)
    assert _rel(reduction.recover(got, torch.tensor(y)).numpy(),
                x_ref) <= 1e-12
    # the JAX package's reduction state handed to the port's SEP core and
    # recovery: the pencil's lowest eigenpairs, B-orthonormal
    red = convert.reduction_from_numpy(ref.a_std, ref.factor, ref.style,
                                       "cpu", torch.float64)
    ctx = pipelines.SolverContext(device=torch.device("cpu"))
    w, z = pipelines.sep_one_stage(ctx, red.a_std, n)
    x = reduction.recover(red, z).numpy()
    assert _rel(w.numpy(), sla.eigh(a, b, eigvals_only=True)) <= 1e-10
    assert np.abs(x.T @ b @ x - np.eye(n)).max() <= 1e-12


def _b_metrics(a, b, w, x):
    r = np.linalg.norm(a @ x - (b @ x) * w[None, :], axis=0).max() \
        / np.linalg.norm(a)
    return r, np.abs(x.T @ b @ x - np.eye(x.shape[1])).max()


@pytest.mark.parametrize("solver", GENERAL)
def test_generalized_solve_matches_jax_and_scipy(monkeypatch, solver):
    monkeypatch.delenv("EK_TRIDIAG", raising=False)
    monkeypatch.delenv("EK_SELECT_CORE", raising=False)
    n = 130
    a, b = _pencil(n, 5)
    k = 20 if registry.get_spec(solver).selecting else None
    kk = n if k is None else k
    got = solve(torch.tensor(a), torch.tensor(b), solver=solver, n_vec=k)
    ref = jax_solve(a, b, solver=solver, n_vec=k)
    w, x = convert.eigenpairs_to_numpy(got)
    assert w.shape == (kk,) and x.shape == (n, kk)
    w_sp = sla.eigh(a, b, eigvals_only=True)[:kk]
    w_ref = np.asarray(ref.values)
    assert _rel(w, w_sp) <= 1e-10 and _rel(w, w_ref) <= 1e-10
    r, orth = _b_metrics(a, b, w, x)
    r_ref, orth_ref = _b_metrics(a, b, w_ref, np.asarray(ref.vectors))
    assert r <= 10 * r_ref + 1e-13
    assert orth <= 10 * orth_ref + 1e-13
    # the verifier's B-metric forms say the same
    _, _, r_v = eval_residual_norm(torch.tensor(a), got, kk, torch.tensor(b))
    assert abs(r_v - r) <= 1e-3 * r + 1e-300
    assert eval_orthogonality(got, 1, kk, torch.tensor(b)) <= 1e-12


def test_standard_and_generalized_names_refuse_the_other_problem():
    a, b = _pencil(20, 6)
    with pytest.raises(ValueError, match="not for generalized"):
        solve(torch.tensor(a), torch.tensor(b), solver="scalapack")
    with pytest.raises(ValueError, match="not for standard"):
        solve(torch.tensor(a), solver="general_elpa2")
    with pytest.raises(ValueError, match="mismatch"):
        solve(torch.tensor(a), torch.tensor(b[:10, :10]),
              solver="general_elpa2")
    with pytest.raises(ValueError, match="partial"):
        solve(torch.tensor(a), torch.tensor(b), solver="general_jacobi",
              n_vec=5)


def test_general_auto_resolves_as_jax():
    a, b = _pencil(60, 7)
    got = solve(torch.tensor(a), torch.tensor(b), solver="general_auto")
    assert got.meta["solver"] == "general_scalapacknew_eigens"
    sel = solve(torch.tensor(a), torch.tensor(b), solver="general_auto",
                n_vec=5)
    assert sel.meta["solver"] == "general_scalapack_select"


def test_ipratios_b_metric_match_jax():
    n = 80
    a, b = _pencil(n, 8)
    x = sla.eigh(a, b)[1]
    pairs = EigenPairs(values=torch.zeros(n), vectors=torch.tensor(x))
    ipr = get_ipratios(pairs, torch.tensor(b))
    from eigenkernel_tpu.core.types import EigenPairs as JaxPairs

    ref = jax_ipratios(JaxPairs(values=jnp.zeros(n), vectors=jnp.asarray(x)),
                       jnp.asarray(b))
    assert _rel(ipr, ref) <= 1e-12
    # B-orthonormal vectors: the B-metric denominators are 1
    assert _rel(ipr, (x ** 4).sum(axis=0)) <= 1e-12


def _write_pair(tmp_path, n, seed):
    a, b = _pencil(n, seed)
    i, j = np.tril_indices(n)
    for name, mat in (("A", a), ("B", b)):
        write_matrix(str(tmp_path / f"{name}.mtx"),
                     SparseMatrix(n, i, j, mat[i, j]))
    return a, b


def _run(main, workdir, argv):
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        return main(argv)
    finally:
        os.chdir(cwd)


# the spans each solve adds to log.json, in their first order
_DC = ["dc:leaves", "dc:deflate", "dc:secular", "wait:dc_depths",
       "dc:vectors"]
EXTRA_SPANS = {
    "general_auto": ["wait:cholesky_info", "wait:drain",
                     "tridiagonalize:panel", "tridiagonalize:update",
                     *_DC, "bt:band"],
    "general_elpa2": ["wait:cholesky_info", "wait:drain", "to_band:panel",
                      "to_band:update", *_DC, "bt:stream", "bt:apply",
                      "bt:band"],
}


@pytest.mark.parametrize("solver", ["general_auto", "general_elpa2"])
def test_cli_generalized_matches_jax_cli(tmp_path, monkeypatch, solver):
    monkeypatch.delenv("EK_TRIDIAG", raising=False)
    n = 72
    _write_pair(tmp_path, n, 9)
    args = ["-s", solver, "-c", "-1", "-t", f"1,{n}",
            str(tmp_path / "A.mtx"), str(tmp_path / "B.mtx")]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    assert _run(jax_main, tmp_path / "jax", args) == 0
    assert _run(port_main, tmp_path / "port",
                ["--platform", "cpu"] + args) == 0
    ev_j = np.loadtxt(tmp_path / "jax" / "eigenvalues.dat")
    ev_p = np.loadtxt(tmp_path / "port" / "eigenvalues.dat")
    assert ev_p.shape == (n, 2)
    assert np.array_equal(ev_p[:, 0], ev_j[:, 0])
    assert _rel(ev_p[:, 1], ev_j[:, 1]) <= 1e-10
    ipr_j = np.loadtxt(tmp_path / "jax" / "ipratios.dat")
    ipr_p = np.loadtxt(tmp_path / "port" / "ipratios.dat")
    assert np.abs(ipr_p - ipr_j).max() <= 1e-8
    log_j = json.loads((tmp_path / "jax" / "log.json").read_text())
    log_p = json.loads((tmp_path / "port" / "log.json").read_text())
    assert log_p["setting"]["solver"] == log_j["setting"]["solver"]
    assert log_p["setting"]["matrix_B_filename"].endswith("B.mtx")
    names_j = [e["name"] for e in log_j["events"]]
    names_p = [e["name"] for e in log_p["events"]]
    # the port's log.json adds its spans' totals (obs/events.py)
    assert [x for x in names_p if x in names_j] == names_j
    assert [x for x in names_p if x not in names_j] == EXTRA_SPANS[solver]
    assert "recovery_generalized" in names_p
