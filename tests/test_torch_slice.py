"""The port's whole slice against the JAX package: ``solve``, the CLI end
to end, its error paths, the registry, and the no-JAX import rule.

Everything runs on the CPU (``--platform cpu``), where the kernels' plain
PyTorch versions stand in for the CUDA kernels.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from eigenkernel_tpu.cli import main as jax_main
from eigenkernel_tpu.solvers import registry as jax_registry
from eigenkernel_tpu.solvers.api import solve as jax_solve
from eigenkernel_tpu_torch.cli import main as port_main
from eigenkernel_tpu_torch.convert import eigenpairs_to_numpy
from eigenkernel_tpu_torch.core.types import SparseMatrix
from eigenkernel_tpu_torch.io.matrix_market import write_matrix
from eigenkernel_tpu_torch.solvers import registry
from eigenkernel_tpu_torch.solvers.api import solve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _sym(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    return (a + a.T) / 2


def _resid_max(a, w, v):
    """max_j ||A v_j - w_j v_j|| / ||A||_F in float64."""
    v = np.asarray(v, np.float64)
    w = np.asarray(w, np.float64)
    r = np.linalg.norm(a @ v - v * w[None, :], axis=0)
    return r.max() / np.linalg.norm(a)


@pytest.mark.parametrize("solver,k,dtype,tridiag", [
    ("scalapack_select", 20, np.float64, None),
    ("scalapack_select", 20, np.float32, None),
    ("scalapack", None, np.float64, "bisect"),
])
def test_solve_matches_jax(monkeypatch, solver, k, dtype, tridiag):
    if tridiag is None:
        monkeypatch.delenv("EK_TRIDIAG", raising=False)
    else:
        monkeypatch.setenv("EK_TRIDIAG", tridiag)
    n = 200
    a = _sym(n, 5)
    ref = jax_solve(a.astype(dtype), solver=solver, n_vec=k)
    got = solve(torch.tensor(a.astype(dtype)), solver=solver, n_vec=k)
    kk = n if k is None else k
    assert got.values.shape == (kk,) and got.vectors.shape == (n, kk)
    assert got.values.dtype == (torch.float64 if dtype == np.float64
                                else torch.float32)
    w_ref = np.asarray(ref.values, np.float64)
    w, v = (x.astype(np.float64) for x in eigenpairs_to_numpy(got))
    norm2 = np.abs(np.linalg.eigvalsh(a)).max()
    f64 = dtype == np.float64
    assert np.abs(w - w_ref).max() <= (1e-12 if f64 else 1e-4) * norm2
    r_ref = _resid_max(a, w_ref, ref.vectors)
    r = _resid_max(a, w, v)
    assert r <= 10 * r_ref + (1e-13 if f64 else 1e-6)
    assert np.abs(v.T @ v - np.eye(kk)).max() <= (1e-12 if f64 else 1e-4)


def _write_mtx(path, n, seed):
    # sparse symmetric: a band plus a few long-range couplings
    a = _sym(n, seed)
    i, j = np.tril_indices(n)
    keep = (i - j <= 6) | (np.random.default_rng(seed).random(i.size) < 0.05)
    write_matrix(str(path), SparseMatrix(n, i[keep], j[keep], a[i, j][keep]))


def _run(main, workdir, argv):
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        return main(argv)
    finally:
        os.chdir(cwd)


def test_cli_end_to_end_matches_jax_cli(tmp_path, monkeypatch):
    monkeypatch.delenv("EK_TRIDIAG", raising=False)
    mtx = tmp_path / "A.mtx"
    _write_mtx(mtx, 90, 11)
    args = ["-s", "scalapack_select", "-n", "12", "-c", "12", "-t", "1,12",
            str(mtx)]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    assert _run(jax_main, tmp_path / "jax", args) == 0
    assert _run(port_main, tmp_path / "port",
                ["--platform", "cpu"] + args) == 0
    ev_j = np.loadtxt(tmp_path / "jax" / "eigenvalues.dat")
    ev_p = np.loadtxt(tmp_path / "port" / "eigenvalues.dat")
    assert ev_p.shape == (12, 2)
    assert np.array_equal(ev_p[:, 0], ev_j[:, 0])
    scale = np.abs(ev_j[:, 1]).max()
    assert np.abs(ev_p[:, 1] - ev_j[:, 1]).max() <= 1e-12 * scale
    ipr_j = np.loadtxt(tmp_path / "jax" / "ipratios.dat")
    ipr_p = np.loadtxt(tmp_path / "port" / "ipratios.dat")
    assert np.abs(ipr_p - ipr_j).max() <= 1e-8
    log_j = json.loads((tmp_path / "jax" / "log.json").read_text())
    log_p = json.loads((tmp_path / "port" / "log.json").read_text())
    assert set(log_p) == {"setting", "events"}
    assert set(log_p["setting"]) == set(log_j["setting"])
    assert log_p["setting"]["solver"] == "scalapack_select"
    assert log_p["setting"]["dimension"] == 90
    names_j = [e["name"] for e in log_j["events"]]
    names_p = [e["name"] for e in log_p["events"]]
    # the port's log.json adds its spans' totals (obs/events.py)
    assert [x for x in names_p if x in names_j] == names_j
    assert [x for x in names_p if x not in names_j] == [
        "tridiagonalize:panel", "tridiagonalize:update", "wait:drain",
        "wait:pivot_floor", "wait:cholesky_info", "bt:band"]
    assert all({"name", "num_repeated", "val"} == set(e)
               for e in log_p["events"])


def test_cli_eigenvector_files(tmp_path):
    mtx = tmp_path / "A.mtx"
    _write_mtx(mtx, 40, 3)
    rc = _run(port_main, tmp_path, [
        "--platform", "cpu", "-s", "scalapack_select", "-n", "5",
        "-d", "vecs", "-p", "1-2,5", str(mtx)])
    assert rc == 0
    for j in (1, 2, 5):
        data = np.loadtxt(tmp_path / "vecs" / f"{j:08d}.dat")
        assert data.shape == (40, 3) and (data[:, 1] == j).all()
    rc = _run(port_main, tmp_path, [
        "--platform", "cpu", "-s", "scalapack_select", "-n", "5",
        "-d", "vecsb", "-p", "1", "--binary", str(mtx)])
    assert rc == 0
    raw = (tmp_path / "vecsb" / "00000001.dat").read_bytes()
    assert len(raw) == 4 + 40 * 8 + 4
    assert np.frombuffer(raw[:4], "<i4")[0] == 320
    assert np.frombuffer(raw[-4:], "<i4")[0] == 320


@pytest.mark.parametrize("case", [
    "matrix_b", "num_processes", "no_card", "unknown_solver",
    "not_ported_core", "mixed_dtype", "missing_file", "dc_core"])
def test_cli_errors_exit_1(tmp_path, monkeypatch, capsys, case):
    mtx = tmp_path / "A.mtx"
    _write_mtx(mtx, 30, 2)
    monkeypatch.delenv("EK_TRIDIAG", raising=False)
    argv = ["--platform", "cpu", "-s", "scalapack_select", "-n", "3",
            str(mtx)]
    if case == "matrix_b":            # a B file of another size than A
        mtx_b = tmp_path / "B.mtx"
        _write_mtx(mtx_b, 31, 3)
        argv = ["--platform", "cpu", "-s", "general_jacobi", str(mtx),
                str(mtx_b)]
    elif case == "num_processes":     # no coordinator to join: at once
        monkeypatch.setenv("EK_NUM_PROCESSES", "2")
        monkeypatch.delenv("EK_COORDINATOR", raising=False)
    elif case == "no_card":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        argv = argv[2:]                  # the default platform is cuda
    elif case == "unknown_solver":
        argv[3] = "nope"
    elif case == "not_ported_core":   # a grid of two processes on one card
        monkeypatch.setenv("EK_NUM_PROCESSES", "2")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        argv = ["--mesh", "1,2", "-s", "jacobi", str(mtx)]
    elif case == "mixed_dtype":       # -n on a core that takes all pairs
        argv = ["--dtype", "mixed", "--platform", "cpu", "-s", "jacobi",
                "-n", "3", str(mtx)]
    elif case == "missing_file":
        argv[-1] = str(tmp_path / "absent.mtx")
    elif case == "dc_core":           # a 2 x 2 grid in a one-process run
        argv = ["--platform", "cpu", "--mesh", "2,2", "-s",
                "scalapack_select", "-n", "3", str(mtx)]
    assert _run(port_main, tmp_path, argv) == 1
    assert "[Error]" in capsys.readouterr().err
    assert not (tmp_path / "eigenvalues.dat").exists()


def test_cli_profile_writes_trace(tmp_path):
    # --profile: torch.profiler around the solve, one trace a process,
    # with the stages' spans
    mtx = tmp_path / "A.mtx"
    _write_mtx(mtx, 40, 4)
    rc = _run(port_main, tmp_path, [
        "--platform", "cpu", "-s", "scalapack_select", "-n", "5",
        "--profile", str(tmp_path / "prof"), str(mtx)])
    assert rc == 0
    trace = json.loads((tmp_path / "prof" / "trace_rank0.json").read_text())
    names = {ev.get("name") for ev in trace["traceEvents"]}
    assert {"sep:tridiagonalize", "sep:tridiag_eigh",
            "sep:back_transform"} <= names
    assert any(str(nm).startswith("aten::") for nm in names)
    # and beside it the join of the trace with the program's spans
    spans = json.loads((tmp_path / "prof" / "spans_rank0.json").read_text())
    assert spans["spans"]["main:eigen_solver"]["count"] == 1
    assert spans["spans"]["tridiagonalize:panel"]["count"] == 1
    assert {"wait:drain", "wait:pivot_floor", "bt:band"} <= set(spans["spans"])


# the spans each of these solves adds to log.json, in their first order;
# a mixed solve's refinement adds its spans and counters last
REFINE = ["refine:start", "refine:step", "refine:steps",
          "wait:refine_clustered", "refine:clustered", "refine:cleanup"]
EXTRA_SPANS = {
    ("jacobi", "float64"): ["wait:drain"],
    ("general_jacobi", "float64"): ["wait:cholesky_info", "wait:drain"],
    ("qdwh_dc", "float64"): ["wait:drain"],
    ("general_qdwh_dc", "float64"): ["wait:cholesky_info", "wait:drain"],
    ("scalapack", "mixed"): ["tridiagonalize:panel", "tridiagonalize:update",
                             "wait:drain", "dc:leaves", "bt:band"] + REFINE,
    ("general_elpa2", "mixed"): ["wait:cholesky_info", "wait:drain",
                                 "to_band:panel", "to_band:update",
                                 "dc:leaves", "bt:stream", "bt:apply",
                                 "bt:band"] + REFINE,
}


@pytest.mark.parametrize("solver,dtype", [
    ("jacobi", "float64"), ("general_jacobi", "float64"),
    ("qdwh_dc", "float64"), ("general_qdwh_dc", "float64"),
    ("scalapack", "mixed"), ("general_elpa2", "mixed")])
def test_cli_extra_cores_and_mixed_match_jax_cli(tmp_path, monkeypatch,
                                                 solver, dtype):
    # the names and the dtype that ran only in the JAX package before;
    # the panel of 16 keeps the plain pair eigh short
    monkeypatch.delenv("EK_TRIDIAG", raising=False)
    n = 48
    a = _sym(n, 12)
    i, j = np.tril_indices(n)
    files = [tmp_path / "A.mtx"]
    write_matrix(str(files[0]), SparseMatrix(n, i, j, a[i, j]))
    if solver.startswith("general"):
        m = np.random.default_rng(13).standard_normal((n, n))
        b = m @ m.T / n + np.eye(n)
        files.append(tmp_path / "B.mtx")
        write_matrix(str(files[1]), SparseMatrix(n, i, j, b[i, j]))
    args = ["-s", solver, "--dtype", dtype, "--block-size", "16", "-c",
            "-1", "-t", f"1,{n}"] + [str(f) for f in files]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    assert _run(jax_main, tmp_path / "jax", args) == 0
    assert _run(port_main, tmp_path / "port",
                ["--platform", "cpu"] + args) == 0
    ev_j = np.loadtxt(tmp_path / "jax" / "eigenvalues.dat")
    ev_p = np.loadtxt(tmp_path / "port" / "eigenvalues.dat")
    assert ev_p.shape == (n, 2)
    assert np.abs(ev_p[:, 1] - ev_j[:, 1]).max() <= 1e-11
    names_j = [e["name"] for e in json.loads(
        (tmp_path / "jax" / "log.json").read_text())["events"]]
    names_p = [e["name"] for e in json.loads(
        (tmp_path / "port" / "log.json").read_text())["events"]]
    # the port's log.json adds its spans' totals (obs/events.py)
    assert [x for x in names_p if x in names_j] == names_j
    assert [x for x in names_p if x not in names_j] == \
        EXTRA_SPANS[solver, dtype]


def test_registry_names_equal_jax():
    assert list(registry.SOLVERS) == list(jax_registry.SOLVERS)
    assert registry.SOLVERS == {
        name: registry.SolverSpec(*(getattr(s, f) for f in (
            "name", "generalized", "selecting", "family", "core",
            "reduction", "single_device", "description")))
        for name, s in jax_registry.SOLVERS.items()}
    for args in [("auto", 100, False, False, False),
                 ("auto", 100, False, True, False),
                 ("general_auto", 20000, True, False, False)]:
        assert registry.resolve_auto(*args, backend="cuda") == \
            jax_registry.resolve_auto(*args, backend="cpu")


def test_port_never_imports_jax(tmp_path):
    mtx = tmp_path / "A.mtx"
    _write_mtx(mtx, 20, 4)
    script = (
        "import importlib, pkgutil, sys\n"
        "import eigenkernel_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "from eigenkernel_tpu_torch.cli import main\n"
        "rc = main(['--platform', 'cpu', '-s', 'scalapack_select', '-n', '3',"
        f" {str(mtx)!r}])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'eigenkernel_tpu'))\n"
        "print('FOREIGN', bad)\n"
        "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "FOREIGN []" in proc.stdout
    assert (tmp_path / "eigenvalues.dat").exists()


def test_module_entry_point_help():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-m", "eigenkernel_tpu_torch",
                           "-h"], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0
    assert "scalapack_select" in proc.stdout
