"""The rest of the JAX package's surface in the port: ``fused_solver``,
``solve``'s default solver, the package exports, ``entry.py`` (the
entry, the grid sweep and the multi-process dry run), the solver sweep
tool, the native MatrixMarket parser, ``read_indexed_values`` and the
whole-solve models ``pipeline_flops`` and ``to_band_bytes``.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: float64 eigenvalues to 1e-10 relative to ||A||_2, residuals
to 1e-12 relative to ||A||_F; the readers and the models must agree
exactly.  Grid runs are spawned gloo ranks on 127.0.0.1
(``torch_mesh_ranks.py`` and ``entry.dryrun_multichip``).
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eigenkernel_tpu
import eigenkernel_tpu_torch
import torch_mesh_ranks as ranks
from eigenkernel_tpu.io import matrix_market as jax_mm
from eigenkernel_tpu.io import outputs as jax_outputs
from eigenkernel_tpu.obs import flops as jax_flops
from eigenkernel_tpu.solvers import api as jax_api
from eigenkernel_tpu_torch import entry
from eigenkernel_tpu_torch.io import matrix_market as mm
from eigenkernel_tpu_torch.io import native_mm, outputs
from eigenkernel_tpu_torch.obs import flops
from eigenkernel_tpu_torch.solvers import api
from eigenkernel_tpu_torch.solvers.registry import SOLVERS
from eigenkernel_tpu_torch.tools import sweep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _pencil(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    m = rng.standard_normal((n, n))
    return (a + a.T) / 2, m @ m.T / n + np.eye(n)


# ---- fused_solver and solve's default ---------------------------------------

@pytest.mark.parametrize("solver,n_vec", [
    ("general_elpa1", None), ("general_elpa2", None), ("eigensx", None),
    ("scalapack_select", 12), ("auto", None)])
def test_fused_solver_matches_jax(solver, n_vec):
    n, block = 96, 32
    a, b = _pencil(n, 3)
    gen = solver.startswith("general")
    args = (a, b) if gen else (a,)
    fn = api.fused_solver(solver, n=n, n_vec=n_vec, block_size=block)
    w, v = fn(*(torch.tensor(x) for x in args))
    ref_fn = jax_api.fused_solver(solver, n=n, n_vec=n_vec, block_size=block)
    ref_w, _ = ref_fn(*(jnp.asarray(x) for x in args))
    k = n if n_vec is None else n_vec
    assert w.shape == (k,) and v.shape == (n, k)
    w, v = w.numpy(), v.numpy()
    norm2 = np.abs(np.linalg.eigvalsh(a)).max()
    assert np.abs(w - np.asarray(ref_w)).max() <= 1e-10 * norm2
    bv = b @ v if gen else v
    resid = np.linalg.norm(a @ v - bv * w, axis=0).max() / np.linalg.norm(a)
    assert resid <= 1e-12


@pytest.mark.parametrize("kwargs", [
    {"solver": "qdwh_dc", "n": 64}, {"solver": "general_qdwh_dc", "n": 64},
    {"solver": "scalapack", "n": 100, "block_size": 32},
    {"solver": "eigensx", "n": 70}])
def test_fused_solver_refuses_as_jax_does(kwargs):
    with pytest.raises(ValueError) as ours:
        api.fused_solver(**kwargs)
    with pytest.raises(ValueError) as theirs:
        jax_api.fused_solver(**kwargs)
    assert str(ours.value) == str(theirs.value)


def test_solve_default_solver_is_jax_default():
    n = 60
    a, b = _pencil(n, 4)
    got = api.solve(a, b, device="cpu")
    ref = jax_api.solve(a, b)
    assert got.meta["solver"] == ref.meta["solver"] == "general_elpa2"
    norm2 = np.abs(np.linalg.eigvalsh(a)).max()
    assert np.abs(got.values.numpy() - np.asarray(ref.values)).max() \
        <= 1e-10 * norm2
    # a standard problem names its solver in both packages
    with pytest.raises(ValueError, match="not for standard problems"):
        api.solve(a, device="cpu")
    with pytest.raises(ValueError, match="not for standard problems"):
        jax_api.solve(a)


# ---- the package exports ----------------------------------------------------

def test_package_exports_match_jax():
    assert set(eigenkernel_tpu.__all__) <= set(eigenkernel_tpu_torch.__all__)
    for name in eigenkernel_tpu.__all__:
        ours = getattr(eigenkernel_tpu_torch, name)
        assert type(ours) is type(getattr(eigenkernel_tpu, name)), name
    assert eigenkernel_tpu_torch.solve is api.solve
    assert eigenkernel_tpu_torch.fused_solver is api.fused_solver
    problem = eigenkernel_tpu_torch.Problem(
        eigenkernel_tpu_torch.SparseMatrix(3, np.zeros(1, np.int64),
                                           np.zeros(1, np.int64),
                                           np.ones(1)))
    assert not problem.is_generalized and problem.dim == 3
    with pytest.raises(AttributeError):
        eigenkernel_tpu_torch.no_such_name


def test_package_import_is_cheap():
    # importing the package imports neither torch.distributed nor a kernel
    code = ("import sys, eigenkernel_tpu_torch; "
            "print(sorted(m for m in sys.modules if m.startswith("
            "('torch', 'eigenkernel'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "['eigenkernel_tpu_torch', " \
                          "'eigenkernel_tpu_torch.version']"


# ---- entry.py and the sweep tool ---------------------------------------------

def test_entry_solves_its_pencil():
    fn, args = entry.entry(device="cpu")
    assert [tuple(x.shape) for x in args] == [(256, 256)] * 2
    assert all(x.dtype == torch.float32 for x in args)
    w, v = fn(*args)
    a, b = (x.double().numpy() for x in args)
    l_inv = np.linalg.inv(np.linalg.cholesky(b))
    ref = np.linalg.eigvalsh(l_inv @ a @ l_inv.T)
    assert np.abs(w.double().numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


def test_sweep_solvers_on_grid(tmp_path):
    ranks.run_ranks("sweep_on_grid", 2, (1, 2), 64, 128, str(tmp_path),
                    timeout=300)
    r = dict(np.load(tmp_path / "rank0.npz"))
    assert r["names"].tolist() == list(SOLVERS)
    assert (r["resid"] < 1e-12).all()


def test_dryrun_multichip_on_cpu_ranks(monkeypatch, capfd):
    monkeypatch.setenv("EK_DRYRUN_SWEEP", "0")
    entry.dryrun_multichip(2, device="cpu", timeout=300)
    out = capfd.readouterr().out
    assert "dryrun_multichip ok: n_processes=2 grid=(1, 2) n=64 " \
           "backend=gloo" in out


def test_sweep_tool_on_cpu(capsys):
    sweep.main(["--n", "48", "--dtype", "float64", "--platform", "cpu",
                "--generalized", "--solvers",
                "general_elpa1,general_scalapack_select", "--select-k", "6"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device: cpu; n=48 dtype=float64")
    rows = [json.loads(x) for x in lines if x.startswith("{")]
    assert [r["solver"] for r in rows] == ["general_elpa1",
                                           "general_scalapack_select"]
    assert rows[1]["n_vec"] == 6 and rows[1]["checked_cols"] == 6
    for r in rows:
        assert r["resid_max"] <= 1e-12 and r["orth"] <= 1e-10
        assert r["time_s"] > 0 and "recovery_generalized" in r["stages"]


# ---- host IO -----------------------------------------------------------------

def _coordinate(path, field, symm, n=9, seed=0, comments=True):
    rng = np.random.default_rng(seed)
    i, j = np.nonzero(np.tril(rng.random((n, n)) < 0.4)
                      if symm == "symmetric" else rng.random((n, n)) < 0.3)
    vals = rng.standard_normal(i.size) * 10
    lines = [f"%%MatrixMarket matrix coordinate {field} {symm}"]
    if comments:
        lines += ["% a comment", "%", ""]
    lines.append(f"{n} {n} {i.size}")
    for k, (r, c) in enumerate(zip(i, j)):
        if field == "pattern":
            lines.append(f"{r + 1} {c + 1}")
        elif field == "integer":
            lines.append(f"{r + 1}   {c + 1}\t{int(vals[k])}")
        else:
            lines.append(f"{r + 1} {c + 1} {vals[k]:.17g}")
        if comments and k % 5 == 2:
            lines.append("")
    path.write_text("\n".join(lines) + "\n")
    return path


def _same(x, y):
    assert x.size == y.size
    assert np.array_equal(x.rows, y.rows) and np.array_equal(x.cols, y.cols)
    assert np.array_equal(x.values, y.values)


@pytest.mark.parametrize("field", ["real", "integer", "pattern"])
@pytest.mark.parametrize("symm", ["symmetric", "general"])
@pytest.mark.parametrize("comments", [True, False])
def test_native_parser_matches_numpy_and_jax(tmp_path, field, symm, comments):
    path = _coordinate(tmp_path / "m.mtx", field, symm, comments=comments)
    got = mm.read_matrix(str(path))
    _same(got, mm._read_numpy(str(path), mm.read_header(str(path))))
    _same(got, jax_mm.read_matrix(str(path)))
    assert got.values.dtype == np.float64


def test_native_parser_reads_comments_between_entries(tmp_path):
    # the numpy parser stops at a '%' line among the entries; both native
    # parsers skip it
    path = tmp_path / "m.mtx"
    path.write_text("%%MatrixMarket matrix coordinate real symmetric\n"
                    "3 3 3\n1 1 2.5\n% between\n2 1 -1e-3\n\n3 3 4\n")
    got = mm.read_matrix(str(path))
    _same(got, jax_mm.read_matrix(str(path)))
    assert got.values.tolist() == [2.5, -1e-3, 4.0]


@pytest.mark.parametrize("text,message", [
    ("%%MatrixMarket matrix coordinate real general\n2 2 3\n1 1 1\n2 2 2\n",
     "expected 3 entries, got 2"),
    ("%%MatrixMarket matrix coordinate real general\n2 2 1\n1 1 1\n2 2 2\n",
     "more entries than the header says"),
    ("%%MatrixMarket matrix coordinate real general\n2 2 2\n1 1 1\n2 x 2\n",
     "a malformed entry")])
def test_native_parser_errors_raise(tmp_path, text, message):
    path = tmp_path / "bad.mtx"
    path.write_text(text)
    with pytest.raises(mm.MatrixMarketError, match=message):
        native_mm.read_coordinate(str(path), mm.read_header(str(path)))


@pytest.mark.parametrize("symm", ["symmetric", "general"])
def test_array_files_match_jax(tmp_path, symm):
    n = 5
    rng = np.random.default_rng(1)
    a = rng.standard_normal((n, n))
    a = a + a.T
    # column-major: the whole matrix, or its lower triangle packed
    r, c = np.tril_indices(n)
    o = np.lexsort((r, c))
    vals = a.T.reshape(-1) if symm == "general" else a[r[o], c[o]]
    path = tmp_path / "a.mtx"
    path.write_text(f"%%MatrixMarket matrix array real {symm}\n% c\n{n} {n}\n"
                    + "\n".join(f"{v:.17g}" for v in vals) + "\n")
    got = mm.read_matrix(str(path))
    _same(got, jax_mm.read_matrix(str(path)))
    assert np.array_equal(got.to_dense(), a)


def test_read_indexed_values_matches_jax(tmp_path):
    vals = np.random.default_rng(2).standard_normal(17) * 1e3
    path = str(tmp_path / "eigenvalues.dat")
    outputs.write_eigenvalues(path, vals)
    got = outputs.read_indexed_values(path)
    assert np.array_equal(got, jax_outputs.read_indexed_values(path))
    assert np.array_equal(got, vals)


# ---- the whole-solve models --------------------------------------------------

@pytest.mark.parametrize("name", list(SOLVERS))
def test_pipeline_flops_match_jax(name):
    spec = SOLVERS[name]
    for n, k, bw in ((4096, 4096, 64), (4096, 500, 64), (16384, 500, 32),
                     (131, 65, 8)):
        args = (spec.core, spec.generalized, spec.reduction, n, k, bw)
        assert flops.pipeline_flops(*args) == jax_flops.pipeline_flops(*args)


@pytest.mark.parametrize("n,bw,itemsize", [(4096, 64, 8), (16384, 32, 4),
                                           (131, 0, 8)])
def test_to_band_bytes_match_jax(n, bw, itemsize):
    assert flops.to_band_bytes(n, bw, itemsize) == \
        jax_flops.to_band_bytes(n, bw, itemsize)
