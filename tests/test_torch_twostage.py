"""The port's two-stage core against the JAX package: band reduction, bulge
chase (kernel B3's plain version), the chase back-transforms (B4's and
B5's plain versions, the WY-grouped ``apply_chase_q_blocked`` and the
model of B5's block schedule), ``solve`` through the two-stage core, the
CLI's ``-s eigensx`` and the ``EK_SELECT_CORE`` switch.

Inputs are made with numpy from a seed and handed to both packages.  The
Pallas kernels run in interpret mode, once each, as the JAX package's own
tests run them on the CPU.  Tolerances: float64 results that the two
packages compute by the same arithmetic in another order agree to 1e-12
relative; the float32 Pallas comparisons use the bars of
``test_pallas_kernels.py`` (spectrum 5e-5 scale) and ``test_bt_blocked.py``
(5e-6 scale).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from eigenkernel_tpu.cli import main as jax_main
from eigenkernel_tpu.ops import band as jax_band
from eigenkernel_tpu.ops import bulge as jax_bulge
from eigenkernel_tpu.solvers.api import solve as jax_solve
from eigenkernel_tpu_torch import convert
from eigenkernel_tpu_torch.cli import main as port_main
from eigenkernel_tpu_torch.core.types import SparseMatrix
from eigenkernel_tpu_torch.io.matrix_market import write_matrix
from eigenkernel_tpu_torch.obs.events import EventLog
from eigenkernel_tpu_torch.ops import (backtransform, band, bulge, chase,
                                       wf_bt)
from eigenkernel_tpu_torch.solvers.api import solve


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _sym(n, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    return ((a + a.T) / 2).astype(dtype)


def _banded(n, bw, seed):
    """A random symmetric band matrix of semibandwidth bw."""
    a = _sym(n, seed)
    return np.triu(np.tril(a, bw), -bw)


def _tri_eigvals(d, e):
    d = np.asarray(d, np.float64)
    e = np.asarray(e, np.float64)
    return np.linalg.eigvalsh(np.diag(d) + np.diag(e, 1) + np.diag(e, -1))


@pytest.mark.parametrize("n", [96, 100])
def test_to_band_and_apply_band_q_match_jax(n):
    bw = 8
    a = _sym(n, n)
    norm = np.abs(np.linalg.eigvalsh(a)).max()
    res = band.to_band(torch.tensor(a), bw)
    got = res.band.numpy()
    i, j = np.indices(got.shape)
    assert np.array_equal(got, got.T)
    assert not got[np.abs(i - j) > bw].any()
    if n % bw == 0:       # the JAX package requires n % bw == 0
        ref = jax_band.to_band(jnp.asarray(a), bw)
        lam_ref = np.linalg.eigvalsh(np.asarray(ref.band))
        # apply_band_q on the JAX package's own reflectors
        z = np.random.default_rng(1).standard_normal((n, 7))
        z_ref = np.asarray(jax_band.apply_band_q(ref, jnp.asarray(z), bw))
        ported = convert.band_from_numpy(ref.band, ref.V, ref.taus, bw,
                                         "cpu", torch.float64)
        z_got = band.apply_band_q(ported, torch.tensor(z)).numpy()
        assert np.abs(z_got - z_ref).max() <= 1e-12 * np.abs(z_ref).max()
    else:
        lam_ref = np.linalg.eigvalsh(a)
    assert np.abs(np.linalg.eigvalsh(got) - lam_ref).max() <= 1e-12 * norm
    # Q band Q^T reproduces A
    q = band.apply_band_q(res, torch.eye(n, dtype=torch.float64)).numpy()
    assert np.abs(q @ got @ q.T - a).max() <= 1e-12 * norm
    assert np.abs(q.T @ q - np.eye(n)).max() <= 1e-12


@pytest.mark.parametrize("n,bw", [(100, 8), (61, 5)])
def test_chase_matches_jax_sequential_and_wavefront(n, bw):
    bnd = _banded(n, bw, n + bw)
    ref_seq = jax_bulge._band_to_tridiag_seq(jnp.asarray(bnd), bw)
    ref_wf = jax_bulge.band_to_tridiag_wavefront2(jnp.asarray(bnd), bw)
    before = chase.LAUNCHES
    got = chase.band_to_tridiag(torch.tensor(bnd), bw)
    assert chase.LAUNCHES == before          # CPU tensors run the plain path
    scale = np.abs(np.asarray(ref_seq.d)).max()
    for ref in (ref_seq, ref_wf):
        assert np.abs(got.d.numpy() - np.asarray(ref.d)).max() <= 1e-12 * scale
        assert np.abs(got.e.numpy() - np.asarray(ref.e)).max() <= 1e-12 * scale
    # the same reflectors, in the same (sweep, position) store
    assert got.HV.shape == tuple(ref_seq.HV.shape)
    assert np.abs(got.HV.numpy() - np.asarray(ref_seq.HV)).max() <= 1e-11
    assert np.abs(got.HT.numpy() - np.asarray(ref_seq.HT)).max() <= 1e-11
    lam = np.linalg.eigvalsh(bnd)
    assert np.abs(_tri_eigvals(got.d, got.e) - lam).max() \
        <= 1e-12 * np.abs(lam).max()


def test_chase_matches_pallas_interpret():
    from eigenkernel_tpu.ops.pallas_chase import band_to_tridiag_pallas

    n, bw = 96, 8
    a = _sym(n, 3, np.float32)
    br = jax_band.to_band(jnp.asarray(a), bw=bw)
    bnd = np.asarray(br.band)
    ref = band_to_tridiag_pallas(br.band, bw, interpret=True)
    got = chase.band_to_tridiag(torch.tensor(bnd), bw)
    lam_band = np.linalg.eigvalsh(bnd.astype(np.float64))
    scale = np.abs(lam_band).max()
    lam_ref = _tri_eigvals(ref.d, ref.e)
    lam_got = _tri_eigvals(got.d, got.e)
    assert np.abs(lam_got - lam_band).max() < 5e-5 * scale
    assert np.abs(lam_got - lam_ref).max() < 5e-5 * scale


# (n, bw, g, m, stream bytes), m the composition depth that the rule
# gives: default g with m > 1, g = b, a g that divides nothing with a
# many-phase stream, and m = 1 (b + g > 64, as at the default b = 64)
_BT_CASES = [(96, 8, 0, 8, wf_bt.STREAM_BYTES), (130, 16, 16, 7, 10 ** 9),
             (157, 8, 5, 15, 20000), (150, 40, 0, 1, wf_bt.STREAM_BYTES)]


@pytest.mark.parametrize("n,bw,g,m,nbytes", _BT_CASES)
def test_back_transforms_match_jax_apply_chase_q(monkeypatch, n, bw, g, m,
                                                 nbytes):
    monkeypatch.delenv("EK_BT_GROUP", raising=False)
    monkeypatch.setattr(wf_bt, "STREAM_BYTES", nbytes)
    rng = np.random.default_rng(n)
    bnd = _banded(n, bw, n)
    ref_res = jax_bulge.band_to_tridiag(jnp.asarray(bnd), bw=bw)
    z = rng.standard_normal((n, 23))
    z_ref = np.asarray(jax_bulge.apply_chase_q(ref_res, jnp.asarray(z), bw))
    res = convert.chase_from_numpy(ref_res.d, ref_res.e, ref_res.HV,
                                   ref_res.HT, bw, "cpu", torch.float64)
    scale = np.abs(z_ref).max()
    pl = wf_bt.plan(res, torch.tensor(z), g)
    assert pl.m == m and (pl.nph > 1) == (nbytes < 10 ** 6)
    before = (wf_bt.LAUNCHES, backtransform.LAUNCHES)
    z4 = wf_bt.apply_chase_q_wavefront(res, torch.tensor(z), g).numpy()
    z5 = backtransform.apply_chase_q_sweeps(res, torch.tensor(z)).numpy()
    assert (wf_bt.LAUNCHES, backtransform.LAUNCHES) == before
    assert np.abs(z4 - z_ref).max() <= 1e-12 * scale
    assert np.abs(z5 - z_ref).max() <= 1e-12 * scale


def test_wavefront_matches_pallas_interpret(monkeypatch):
    # a tests/test_bt_blocked.py shape; m = 2 there by the default rule,
    # and a small stream budget splits both streams into several phases
    from eigenkernel_tpu.ops.pallas_wf_bt import (
        apply_chase_q_wavefront_pallas)

    n, bw, g = 224, 32, 64
    rng = np.random.default_rng(7)
    a = rng.standard_normal((n, n)).astype(np.float32)
    bnd = np.triu(np.tril(a + a.T, bw), -bw)
    ref_res = jax_bulge.band_to_tridiag(jnp.asarray(bnd), bw=bw)
    z = rng.standard_normal((n, 40)).astype(np.float32)
    monkeypatch.setenv("EK_WF_BT_STREAM", "300000")
    z_ref = np.asarray(apply_chase_q_wavefront_pallas(
        ref_res, jnp.asarray(z), bw=bw, group=g, interpret=True))
    res = convert.chase_from_numpy(ref_res.d, ref_res.e, ref_res.HV,
                                   ref_res.HT, bw, "cpu", torch.float32)
    monkeypatch.setattr(wf_bt, "STREAM_BYTES", 300000)
    pl = wf_bt.plan(res, torch.tensor(z), g)
    assert pl.m == 2 and pl.nph > 1
    got = wf_bt.apply_chase_q_wavefront(res, torch.tensor(z), g).numpy()
    scale = max(np.abs(z_ref).max(), 1.0)
    assert np.abs(got - z_ref).max() / scale < 5e-6


# (n, bw, g, zeroed band columns): the tests/test_bt_blocked.py shapes;
# g = 1, 5, b and 2b (clamped to b); n - 2 not a multiple of g (a partial
# last group); 0 for the default (32, clamped); zeroed columns give
# windows of tau = 0 reflectors
_BLOCKED_CASES = [(96, 8, 4, ()), (130, 16, 16, ()), (64, 4, 3, ()),
                  (157, 8, 5, ()), (96, 8, 1, ()), (96, 8, 5, ()),
                  (100, 8, 8, ()), (100, 8, 16, ()), (101, 16, 0, ()),
                  (64, 8, 5, (10, 11, 30))]


@pytest.mark.parametrize("n,bw,g,zero_cols", _BLOCKED_CASES)
def test_blocked_matches_jax_and_sweeps(n, bw, g, zero_cols):
    rng = np.random.default_rng(n + bw)
    bnd = _banded(n, bw, n + bw + g)
    for c in zero_cols:
        bnd[c, :] = 0
        bnd[:, c] = 0
    ref_res = jax_bulge.band_to_tridiag(jnp.asarray(bnd), bw=bw)
    if zero_cols:
        assert (np.asarray(ref_res.HT)[:n - 2] == 0).any()
    z = rng.standard_normal((n, 11))
    z_ref = np.asarray(jax_bulge.apply_chase_q_blocked(
        ref_res, jnp.asarray(z), bw=bw, group=g))
    res = convert.chase_from_numpy(ref_res.d, ref_res.e, ref_res.HV,
                                   ref_res.HT, bw, "cpu", torch.float64)
    got = bulge.apply_chase_q_blocked(res, torch.tensor(z), g).numpy()
    sweeps = bulge.apply_chase_q(res, torch.tensor(z)).numpy()
    scale = np.abs(z_ref).max()
    assert np.abs(got - z_ref).max() <= 1e-12 * scale
    assert np.abs(got - sweeps).max() <= 1e-12 * scale


def test_sweeps_plain_matches_pallas_interpret():
    # B5's plain version against the Pallas kernel it replaces, at the
    # shape of test_pallas_kernels.py::test_apply_chase_q_pallas
    from eigenkernel_tpu.ops.pallas_backtransform import apply_chase_q_pallas

    n, bw = 96, 8
    rng = np.random.default_rng(2)
    ref_res = jax_bulge.band_to_tridiag(jnp.asarray(_banded(n, bw, 9)), bw)
    z = rng.standard_normal((n, 33))
    z_ref = np.asarray(apply_chase_q_pallas(ref_res.HV, ref_res.HT,
                                            jnp.asarray(z), bw,
                                            interpret=True))
    res = convert.chase_from_numpy(ref_res.d, ref_res.e, ref_res.HV,
                                   ref_res.HT, bw, "cpu", torch.float64)
    before = backtransform.LAUNCHES
    got = backtransform.apply_chase_q_sweeps(res, torch.tensor(z)).numpy()
    assert backtransform.LAUNCHES == before
    assert np.abs(got - z_ref).max() <= 1e-12 * np.abs(z_ref).max()


def _schedule_order(n, b, T, g, descending=False):
    """order[c, t]: when B5's block schedule applies reflector (c, t), or
    -1 where it never does; ``descending`` turns the positions of each
    group around (a wrong order, to show the check can fail)."""
    blocks = list(backtransform.block_schedule(n, b, T, g))
    if descending:
        blocks.sort(key=lambda blk: (blk[0], -blk[1]))
    order = np.full((n, T), -1)
    pos = 0
    for _, t, c0, _ in blocks:
        for c in range(c0, max(c0 - g, -1), -1):      # newest sweep first
            assert order[c, t] == -1
            order[c, t] = pos
            pos += 1
    return order[:n - 2]


def _keeps_sweep_order(order, b):
    """Whether every overlapping pair (c, t), (c - dc, t + dt), dc > 0
    (windows c + 1 + t b, b rows each, less than b rows apart) that both
    run is applied newer sweep first, as in the sweep-by-sweep product."""
    ns, T = order.shape
    for dc in range(1, ns):
        for dt in range(dc // b - 1, dc // b + 2):
            if abs(dc - dt * b) >= b:
                continue
            t_lo, t_hi = max(0, -dt), min(T, T - dt)
            if t_lo >= t_hi:
                continue
            newer = order[dc:, t_lo:t_hi]
            older = order[:ns - dc, t_lo + dt:t_hi + dt]
            both = (newer >= 0) & (older >= 0)
            if (newer[both] > older[both]).any():
                return False
    return True


@pytest.mark.parametrize("b", [3, 8, 16])
@pytest.mark.parametrize("n", [5, 96, 157])
def test_block_schedule_keeps_the_sweep_order(n, b):
    T = n // b + 2
    c = np.arange(n - 2)[:, None]
    t = np.arange(T)[None, :]
    live = c + 1 + t * b < n          # windows that start inside z
    for g in range(1, b + 1):         # every g the kernel allows
        order = _schedule_order(n, b, T, g)
        assert (order[live] >= 0).all()
        assert _keeps_sweep_order(order, b)
        pl = backtransform.plan_of(n, b, T, 1, 8, g)
        assert pl.g == g and pl.blocks == sum(
            1 for _ in backtransform.block_schedule(n, b, T, g))
    if n > 2 * b:
        # the check catches a wrong order: positions descending in a group
        assert not _keeps_sweep_order(_schedule_order(n, b, T, b, True), b)
    # g > b is clamped, as in the JAX package
    assert backtransform.plan_of(n, b, T, 1, 8, 2 * b).g == b


def _resid_max(a, w, v):
    v = np.asarray(v, np.float64)
    w = np.asarray(w, np.float64)
    return (np.linalg.norm(a @ v - v * w[None, :], axis=0).max()
            / np.linalg.norm(a))


@pytest.mark.parametrize("solver,k,dtype,env,bt", [
    ("eigensx", None, np.float64, {"EK_TRIDIAG": "bisect"}, "auto"),
    ("scalapack_select", 20, np.float64, {"EK_SELECT_CORE": "two_stage"},
     "auto"),
    ("scalapack_select", 20, np.float32, {"EK_SELECT_CORE": "two_stage"},
     "auto"),
    # the port's B5 path against the JAX package's default back-transform
    # (its Pallas B5 kernel needs a TPU outside interpret mode)
    ("scalapack_select", 20, np.float64, {"EK_SELECT_CORE": "two_stage"},
     "pallas"),
])
def test_two_stage_solve_matches_jax(monkeypatch, solver, k, dtype, env, bt):
    for var in ("EK_TRIDIAG", "EK_SELECT_CORE", "EK_BACKTRANSFORM"):
        monkeypatch.delenv(var, raising=False)
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    n = 200
    a = _sym(n, 5)
    ref = jax_solve(a.astype(dtype), solver=solver, n_vec=k)
    monkeypatch.setenv("EK_BACKTRANSFORM", bt)
    got = solve(torch.tensor(a.astype(dtype)), solver=solver, n_vec=k)
    assert got.meta["core"] == "two_stage"
    kk = n if k is None else k
    assert got.values.shape == (kk,) and got.vectors.shape == (n, kk)
    w_ref = np.asarray(ref.values, np.float64)
    w, v = (x.astype(np.float64) for x in convert.eigenpairs_to_numpy(got))
    norm2 = np.abs(np.linalg.eigvalsh(a)).max()
    f64 = dtype == np.float64
    assert np.abs(w - w_ref).max() <= (1e-12 if f64 else 1e-4) * norm2
    r_ref = _resid_max(a, w_ref, ref.vectors)
    assert _resid_max(a, w, v) <= 10 * r_ref + (1e-13 if f64 else 1e-6)
    assert np.abs(v.T @ v - np.eye(kk)).max() <= (1e-12 if f64 else 1e-4)


def _event_names(solver="scalapack_select", k=6):
    log = EventLog(stream=False)
    solve(torch.tensor(_sym(40, 2)), solver=solver, n_vec=k, log=log)
    return [e["name"] for e in log.events()]


def test_select_core_env_pins_the_core(monkeypatch):
    monkeypatch.setenv("EK_SELECT_CORE", "two_stage")
    names = _event_names()
    assert "sep:full_to_band" in names and "sep:band_to_tridiag" in names
    assert "sep:tridiagonalize" not in names
    for sel in ("one_stage", "auto"):
        monkeypatch.setenv("EK_SELECT_CORE", sel)
        names = _event_names()
        assert "sep:tridiagonalize" in names
        assert "sep:full_to_band" not in names


@pytest.mark.parametrize("solver,k,env", [
    ("eigensx", None, {"EK_TRIDIAG": "bisect"}),
    ("scalapack_select", 15, {"EK_SELECT_CORE": "two_stage",
                              "EK_BT_GROUP": "5"})])
def test_blocked_back_transform_through_solve(monkeypatch, solver, k, env):
    for var in ("EK_TRIDIAG", "EK_SELECT_CORE", "EK_BT_GROUP"):
        monkeypatch.delenv(var, raising=False)
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    monkeypatch.setenv("EK_BACKTRANSFORM", "blocked")
    n = 110
    a = _sym(n, 17)
    got = solve(torch.tensor(a), solver=solver, n_vec=k)
    assert got.meta["core"] == "two_stage"
    kk = n if k is None else k
    w, v = convert.eigenpairs_to_numpy(got)
    w_ref = sla.eigh(a, eigvals_only=True)[:kk]
    norm2 = np.abs(w_ref).max()
    assert v.shape == (n, kk)
    assert np.abs(w - w_ref).max() <= 1e-12 * norm2
    assert _resid_max(a, w, v) <= 1e-14
    assert np.abs(v.T @ v - np.eye(kk)).max() <= 1e-12


@pytest.mark.parametrize("method", ["wavefront", "nope"])
def test_unported_back_transforms_raise(monkeypatch, method):
    monkeypatch.setenv("EK_SELECT_CORE", "two_stage")
    monkeypatch.setenv("EK_BACKTRANSFORM", method)
    with pytest.raises(NotImplementedError):
        _event_names()


def _write_mtx(path, n, seed):
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


def test_cli_eigensx_matches_jax_cli(tmp_path, monkeypatch):
    monkeypatch.setenv("EK_TRIDIAG", "bisect")
    mtx = tmp_path / "A.mtx"
    _write_mtx(mtx, 90, 13)
    args = ["-s", "eigensx", "-c", "-1", "-t", "1,90", str(mtx)]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    assert _run(jax_main, tmp_path / "jax", args) == 0
    assert _run(port_main, tmp_path / "port",
                ["--platform", "cpu"] + args) == 0
    ev_j = np.loadtxt(tmp_path / "jax" / "eigenvalues.dat")
    ev_p = np.loadtxt(tmp_path / "port" / "eigenvalues.dat")
    assert ev_p.shape == (90, 2)
    scale = np.abs(ev_j[:, 1]).max()
    assert np.abs(ev_p[:, 1] - ev_j[:, 1]).max() <= 1e-12 * scale
    log_j = json.loads((tmp_path / "jax" / "log.json").read_text())
    log_p = json.loads((tmp_path / "port" / "log.json").read_text())
    assert log_p["setting"]["solver"] == "eigensx"
    names_j = [e["name"] for e in log_j["events"]]
    names_p = [e["name"] for e in log_p["events"]]
    # the port's log.json adds its spans' totals (obs/events.py)
    assert [x for x in names_p if x in names_j] == names_j
    assert [x for x in names_p if x not in names_j] == [
        "to_band:panel", "to_band:update", "wait:drain", "wait:pivot_floor",
        "wait:cholesky_info", "bt:stream", "bt:apply", "bt:band"]
    for stage in ("sep:full_to_band", "sep:band_to_tridiag",
                  "sep:tridiag_eigh", "sep:back_transform"):
        assert stage in names_p and f"!{stage}_Gflops" in names_p


def test_wrappers_refuse_what_the_kernels_do_not_take():
    bnd = torch.tensor(_banded(20, 3, 1))
    with pytest.raises(TypeError):
        chase.band_to_tridiag(bnd.half(), 3)
    with pytest.raises(ValueError):
        chase.band_to_tridiag(bnd[:, :10], 3)
    res = chase.band_to_tridiag(bnd, 3)
    z = torch.zeros((20, 4), dtype=torch.float64)
    with pytest.raises(TypeError):
        wf_bt.apply_chase_q_wavefront(res, z.float())
    with pytest.raises(TypeError):
        backtransform.apply_chase_q_sweeps(res, z.float())
    # a device that is neither the CPU nor CUDA is refused, not run plain
    meta = bulge.ChaseResult(*(t.to("meta") for t in res[:4]), bw=3)
    with pytest.raises(ValueError):
        chase.band_to_tridiag(bnd.to("meta"), 3)
    with pytest.raises(ValueError):
        wf_bt.apply_chase_q_wavefront(meta, z.to("meta"))
    with pytest.raises(ValueError):
        backtransform.apply_chase_q_sweeps(meta, z.to("meta"))
