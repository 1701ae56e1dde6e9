"""The port's multi-process runtime (``parallel/multihost.py``) and the
CLI on several processes, all gloo on the CPU on 127.0.0.1.

Each test that starts processes has its own timeout and kills them on
failure; a test writes its own MatrixMarket file.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import torch_mesh_ranks as ranks
from eigenkernel_tpu_torch.cli import main as port_main
from eigenkernel_tpu_torch.core.types import MatrixInfo, SparseMatrix
from eigenkernel_tpu_torch.io.matrix_market import write_matrix
from eigenkernel_tpu_torch.parallel import multihost as mh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _write_mtx(path, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    i, j = np.tril_indices(n)
    keep = (i - j <= 5) | (rng.random(i.size) < 0.1)
    write_matrix(str(path), SparseMatrix(n, i[keep], j[keep], a[i, j][keep]))


def _write_spd(path, n, seed):
    """An SPD B (diagonally dominant, a band of 4), written whole."""
    rng = np.random.default_rng(seed)
    b = np.zeros((n, n))
    for d in range(1, 5):
        off = 0.3 * rng.standard_normal(n - d)
        b += np.diag(off, d) + np.diag(off, -d)
    b += np.diag(1.0 + np.abs(b).sum(axis=1))
    i, j = np.tril_indices(n)
    keep = b[i, j] != 0
    write_matrix(str(path), SparseMatrix(n, i[keep], j[keep], b[i, j][keep]))
    return b


def _read_dense(path):
    from eigenkernel_tpu_torch.io.matrix_market import read_header, read_matrix

    return read_matrix(str(path), read_header(str(path))).to_dense()


def _run_processes(workdir, argv, world=2, extra_env=None):
    """``python -m eigenkernel_tpu_torch argv`` as ``world`` processes of
    one run; returns (exit codes, outputs)."""
    env_base = dict(os.environ, EK_NUM_PROCESSES=str(world),
                    EK_COORDINATOR=f"127.0.0.1:{ranks.free_port()}",
                    PYTHONPATH=ROOT, OMP_NUM_THREADS="1", **(extra_env or {}))
    procs = []
    try:
        for pid in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "eigenkernel_tpu_torch", *argv],
                cwd=workdir, env=dict(env_base, EK_PROCESS_ID=str(pid)),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        outs = [p.communicate(timeout=TIMEOUT_S)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


def test_init_distributed_names_its_peers():
    # more than one process and no coordinator or id: raise, wait for no one
    with pytest.raises(ValueError):
        mh.init_distributed(None, 2, 0)
    with pytest.raises(ValueError):
        mh.init_distributed("127.0.0.1:1", 2, None)
    mh.init_distributed(None, None, None)      # one process: nothing to do
    assert not torch.distributed.is_initialized()
    assert mh.is_master() and mh.process_count() == 1


def test_bcast_round_trips(tmp_path):
    info = MatrixInfo(rep="coordinate", field="real", symm="symmetric",
                      rows=50, cols=50, entries=7)
    rng = np.random.default_rng(40)
    coo = (np.array([0, 3, 9, 20, 31, 40, 49]),
           np.array([0, 1, 9, 2, 30, 40, 0]), rng.standard_normal(7))
    ranks.run_ranks("bcast_round_trip", 2, info, coo, str(tmp_path))
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz", allow_pickle=True)
        assert list(got["info"]) == ["coordinate", "real", "symmetric", 50,
                                     50, 7]
        assert int(got["size"]) == 50
        assert np.array_equal(got["rows"], coo[0])
        assert np.array_equal(got["cols"], coo[1])
        assert np.array_equal(got["values"], coo[2])
        # process 0's word decides: ok, then not ok; a failed probe is None
        assert got["ok"].tolist() == [True, False]
        assert bool(got["failed"])


@pytest.mark.parametrize("solver,k,extra", [
    pytest.param("scalapack", None, [], id="scalapack-None"),
    pytest.param("scalapack_select", 6, [], id="scalapack_select-6"),
    pytest.param("lapack", None, [], id="lapack-None"),
    pytest.param("jacobi", None, ["--block-size", "16"], id="jacobi-None"),
    pytest.param("qdwh_dc", None, [], id="qdwh_dc-None"),
    pytest.param("scalapack", None, ["--dtype", "mixed"],
                 id="scalapack-mixed")])
def test_two_process_cli(tmp_path, solver, k, extra):
    n = 60
    mtx = tmp_path / "A.mtx"
    _write_mtx(mtx, n, 41)
    kk = n if k is None else k
    argv = ["--platform", "cpu", *extra, "-s", solver, "-c", "-1", "-t",
            f"1,{kk}", "-d", "vec", "-p", "1-4", str(mtx)]
    if k is not None:
        argv[-9:-9] = ["-n", str(k)]
    two = tmp_path / "two"
    two.mkdir()
    codes, outs = _run_processes(two, ["--mesh", "1,2", *argv])
    assert codes == [0, 0], outs
    assert "processes: 2" in outs[0]
    one = tmp_path / "one"
    one.mkdir()
    cwd = os.getcwd()
    os.chdir(one)
    try:
        assert port_main(argv) == 0
    finally:
        os.chdir(cwd)
    ev2 = np.loadtxt(two / "eigenvalues.dat")
    ev1 = np.loadtxt(one / "eigenvalues.dat")
    assert ev2.shape == (kk, 2)
    assert np.abs(ev2[:, 1] - ev1[:, 1]).max() <= 1e-12
    ref = np.linalg.eigvalsh(_read_dense(mtx))[:kk]
    assert np.abs(ev2[:, 1] - ref).max() <= 1e-12 * np.abs(ref).max()
    files = sorted(os.listdir(two / "vec"))
    assert files == [f"{j:08d}.dat" for j in range(1, 5)]
    for j in range(1, 5):
        v2 = np.loadtxt(two / "vec" / f"{j:08d}.dat")
        v1 = np.loadtxt(one / "vec" / f"{j:08d}.dat")
        assert v2.shape == (n, 3)
        # the same vector, up to its sign
        assert min(np.abs(v2[:, 2] - v1[:, 2]).max(),
                   np.abs(v2[:, 2] + v1[:, 2]).max()) <= 1e-10
    # the checks ran on the grid and met the float64 bars
    for line in outs[0].splitlines():
        if line.startswith(("residual norm (max)", "orthogonality")):
            assert float(line.split()[-1]) <= 1e-12


def test_two_process_master_error_no_deadlock(tmp_path):
    # a missing input on process 0: both processes exit 1, no deadlock
    codes, outs = _run_processes(tmp_path, [
        "--platform", "cpu", "--mesh", "1,2", "-s", "scalapack",
        str(tmp_path / "missing.mtx")])
    assert codes == [1, 1], outs
    assert any("[Error]" in o for o in outs)


def test_two_process_cli_generalized(tmp_path):
    # -s general_elpa2 on a 1 x 2 grid: B broadcast and densified by block,
    # the elpa reduction, to_band, the chase on both ranks and the
    # sharded back-transform; the B-metric checks run on the grid
    _two_process_generalized(tmp_path, "general_elpa2", [])


@pytest.mark.parametrize("solver,extra", [
    ("general_jacobi", ["--block-size", "16"]), ("general_qdwh_dc", [])])
def test_two_process_cli_generalized_extra_cores(tmp_path, solver, extra):
    # the same for the cores of slice 7d: block columns and D2's plain
    # version on each rank's pairs (general_jacobi), the recursion's leaf
    # gathered (general_qdwh_dc)
    _two_process_generalized(tmp_path, solver, extra)


def _two_process_generalized(tmp_path, solver, extra):
    n = 70
    _write_mtx(tmp_path / "A.mtx", n, 43)
    b = _write_spd(tmp_path / "B.mtx", n, 44)
    a = _read_dense(tmp_path / "A.mtx")
    codes, outs = _run_processes(tmp_path, [
        "--platform", "cpu", "--mesh", "1,2", *extra, "-s", solver, "-c",
        "-1", "-t", f"1,{n}", "-d", "vec", "-p", "1-2",
        str(tmp_path / "A.mtx"), str(tmp_path / "B.mtx")])
    assert codes == [0, 0], outs
    ev = np.loadtxt(tmp_path / "eigenvalues.dat")
    ref = sla.eigh(a, b, eigvals_only=True)
    assert ev.shape == (n, 2)
    assert np.abs(ev[:, 1] - ref).max() <= 1e-12 * np.abs(ref).max()
    checks = {}
    for line in outs[0].splitlines():
        if line.startswith(("residual norm (max)", "orthogonality")):
            checks[line.split()[0]] = float(line.split()[-1])
    assert checks["residual"] <= 1e-12 and checks["orthogonality"] <= 1e-10
    # each vector B-normalized, the ipratios in the B metric
    ipr = np.loadtxt(tmp_path / "ipratios.dat")
    for j in (1, 2):
        v = np.loadtxt(tmp_path / "vec" / f"{j:08d}.dat")[:, 2]
        assert abs(v @ b @ v - 1.0) <= 1e-10
        assert abs(ipr[j - 1, 1] - (v ** 4).sum() / (v @ b @ v) ** 2) \
            <= 1e-10 * ipr[j - 1, 1]
