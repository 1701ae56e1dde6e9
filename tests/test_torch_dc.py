"""The port's divide and conquer (``ops/dc.py``) against the JAX package's
``ops/dc.py`` and scipy, on the spectra of ``tests/test_dc.py``.

On the CPU the deflation scans run their plain PyTorch version
(``deflate_scan_plain``), which is held here, bit for bit, to a
transcription of the JAX function's ``t2step`` and ``depth_step`` in
numpy scalars; the card tests hold the kernel D1 to it.  Tolerances are
those of ``test_dc.py::_check``: eigenvalues and residual to 5e-13 of
max(|lambda|, 1), orthogonality to 1e-13; float32 to its test's 5e-5
and 5e-6.  Vectors are compared by residual and orthogonality, never raw:
the leaf eigensolvers of the two packages may pick other signs.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from eigenkernel_tpu.ops import dc as jax_dc
from eigenkernel_tpu.ops.tridiag import tridiag_eigh as jax_tridiag_eigh
from eigenkernel_tpu_torch.ops import dc
from eigenkernel_tpu_torch.ops import tridiag as td


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _tmat(d, e):
    t = np.diag(d)
    if len(d) > 1:
        t = t + np.diag(e, 1) + np.diag(e, -1)
    return t


def _degenerate():
    rng = np.random.default_rng(7)
    n = 128
    w_deg = np.repeat(np.arange(n // 4), 4).astype(float)
    qr, _ = np.linalg.qr(rng.standard_normal((n, n)))
    td_ = sla.hessenberg((qr * w_deg[None, :]) @ qr.T)
    return np.diag(td_).copy(), np.diag(td_, -1).copy()


def _spectrum(name):
    rng = np.random.default_rng(17)
    if name.startswith("random"):
        n = int(name[6:])
        rng = np.random.default_rng(n)
        return rng.standard_normal(n), rng.standard_normal(n - 1)
    if name == "degenerate":
        return _degenerate()
    if name == "wilkinson":
        n = 201
        return np.abs(np.arange(n) - n // 2).astype(float), np.ones(n - 1)
    if name == "glued":
        k = np.abs(np.arange(21) - 10).astype(float)
        e = np.ones(21 * 6 - 1)
        e[20::21] = 1e-8
        return np.tile(k, 6), e
    if name == "alternating":
        d = rng.standard_normal(300)
        return d, np.where(np.arange(299) % 2 == 0, 1e-13, 1.0) \
            * rng.standard_normal(299)
    if name == "gradient":
        d = np.concatenate([rng.standard_normal(96) * 1e8,
                            rng.standard_normal(96),
                            rng.standard_normal(96) * 1e-8])
        return d, rng.standard_normal(287)
    if name == "zero":
        return np.zeros(100), np.zeros(99)
    if name == "deflated":
        return np.ones(96), np.zeros(95)
    assert name == "decoupled"
    rng = np.random.default_rng(3)
    return rng.standard_normal(200), 1e-14 * rng.standard_normal(199)


@pytest.mark.parametrize("name", [
    "random3", "random17", "random65", "random130", "degenerate",
    "wilkinson", "glued", "alternating", "gradient", "zero", "deflated",
    "decoupled"])
def test_tridiag_dc_matches_jax_and_scipy(name):
    d, e = _spectrum(name)
    n = len(d)
    t = _tmat(d, e)
    w, q = dc.tridiag_dc(torch.tensor(d), torch.tensor(e))
    w, q = w.numpy(), q.numpy()
    w_jax, _ = jax.jit(jax_dc.tridiag_dc)(jnp.asarray(d), jnp.asarray(e))
    w_sp = sla.eigh_tridiagonal(d, e, eigvals_only=True) if n > 1 else d
    scale = max(np.abs(w_sp).max(), 1.0)
    assert w.shape == (n,) and q.shape == (n, n)
    assert np.abs(w - np.asarray(w_jax)).max() / scale < 5e-13
    assert np.abs(w - w_sp).max() / scale < 5e-13
    assert np.abs(t @ q - q * w[None, :]).max() / scale < 5e-13
    assert np.abs(q.T @ q - np.eye(n)).max() < 1e-13


def test_tridiag_dc_float32():
    rng = np.random.default_rng(5)
    n = 96
    d = rng.standard_normal(n).astype(np.float32)
    e = rng.standard_normal(n - 1).astype(np.float32)
    w_ref = np.linalg.eigvalsh(_tmat(d, e).astype(np.float64))
    w, q = dc.tridiag_dc(torch.tensor(d), torch.tensor(e))
    assert w.dtype == torch.float32 and q.dtype == torch.float32
    w_jax, _ = jax.jit(jax_dc.tridiag_dc)(jnp.asarray(d), jnp.asarray(e))
    w, q = w.double().numpy(), q.double().numpy()
    scale = np.abs(w_ref).max()
    assert np.abs(w - w_ref).max() / scale < 5e-5
    assert np.abs(w - np.asarray(w_jax, np.float64)).max() / scale < 5e-5
    assert np.abs(q.T @ q - np.eye(n)).max() < 5e-6


def _halves(K2, seed, kind):
    """The solved halves of one merge: eigenpairs of two random
    tridiagonals, or the same one twice (every pole doubled: type-2
    deflation), with the coupling; kind 'decoupled' has e_mid = 0."""
    rng = np.random.default_rng(seed)
    out = []
    for h in range(2):
        if kind != "repeated" or h == 0:
            t = _tmat(rng.standard_normal(K2), rng.standard_normal(K2 - 1))
            w, q = np.linalg.eigh(t)
        out.append((w, q))
    e_mid = 0.0 if kind == "decoupled" else rng.standard_normal()
    return out[0][0], out[1][0], out[0][1], out[1][1], e_mid


def test_merge_one_matches_jax():
    K2, iters = 40, 60
    cases = [_halves(K2, s, k) for s, k in
             ((1, "random"), (2, "repeated"), (3, "decoupled"))]
    w1, w2, q1, q2, e_mid = (np.stack([c[i] for c in cases])
                             for i in range(5))
    w, q = dc._merge_one(*(torch.tensor(x) for x in (w1, w2, q1, q2, e_mid)),
                         iters)
    w_j, q_j = jax.vmap(partial(jax_dc._merge_one, iters=iters))(
        *(jnp.asarray(x) for x in (w1, w2, q1, q2, e_mid)))
    w, q = w.numpy(), q.numpy()
    w_j, q_j = np.asarray(w_j), np.asarray(q_j)
    for b in range(len(cases)):
        # the merged matrix: blkdiag(T1, T2) adjusted + rank one
        t = np.zeros((2 * K2, 2 * K2))
        t[:K2, :K2] = (q1[b] * w1[b]) @ q1[b].T
        t[K2:, K2:] = (q2[b] * w2[b]) @ q2[b].T
        rho, s = abs(e_mid[b]), 1.0 if e_mid[b] >= 0 else -1.0
        v = np.zeros(2 * K2)
        v[K2 - 1], v[K2] = 1.0, s
        t = t + rho * np.outer(v, v)
        scale = max(np.abs(w[b]).max(), 1.0)
        assert np.abs(w[b] - w_j[b]).max() / scale < 5e-13
        assert np.abs(w[b] - np.linalg.eigvalsh(t)).max() / scale < 5e-13
        assert np.abs(t @ q[b] - q[b] * w[b]).max() / scale < 5e-13
        assert np.abs(q[b].T @ q[b] - np.eye(2 * K2)).max() < 1e-13
        # the same halves give the same vectors up to rounding
        assert np.abs(np.abs(q[b].T @ q_j[b]) - np.eye(2 * K2)).max() < 1e-9


def _scan_numpy(ds, us, alive, tol):
    """The JAX function's t2step and depth_step transcribed for one merge
    in numpy scalars (one rounding per operation)."""
    has, ip, dp, up = False, 0, ds.dtype.type(0), ds.dtype.type(0)
    last_i, last_d = -1, 0
    recs = []
    for i in range(len(ds)):
        di, ui, al = ds[i], us[i], bool(alive[i])
        r = np.sqrt(up * up + ui * ui)
        r_safe = ds.dtype.type(1) if r == 0 else r
        c = ui / r_safe
        sn = up / r_safe
        close = has and al and abs((di - dp) * c * sn) <= tol
        fin_prev = has and al and not close
        fin_self = not al
        fin_d = c * c * dp + sn * sn * di if close else \
            (di if fin_self else dp)
        depth = last_d + 1 if close and ip == last_i else 0
        recs.append((i if fin_self else ip, fin_d,
                     up if fin_prev else ds.dtype.type(0),
                     close or fin_prev or fin_self, ip, i, c, sn, close,
                     depth if close else -1))
        if close:
            last_i, last_d = i, depth
        if al:
            dp = sn * sn * dp + c * c * di if close else di
            up = r if close else ui
            ip, has = i, True
    return recs, (has, ip, dp, up)


def _scan_case(kind, dtype, nb=3, K=70):
    rng = np.random.default_rng({"none": 1, "some": 2, "full": 3,
                                 "dead": 4}[kind])
    ds = np.sort(rng.standard_normal((nb, K)), axis=1)
    if kind == "none":            # poles at least 0.5 apart
        ds = np.arange(K) + rng.uniform(-0.25, 0.25, (nb, K))
    elif kind == "some":          # pairs of equal poles
        ds[:, 1::3] = ds[:, 0::3][:, :ds[:, 1::3].shape[1]]
    elif kind == "full":          # every pole equal: one long chain
        ds[:] = ds[:, :1]
    us = rng.choice([-1.0, 1.0], (nb, K)) * rng.uniform(0.5, 1.0, (nb, K))
    us /= np.sqrt(K)
    alive = np.ones((nb, K), bool)
    if kind == "some":
        alive[:, ::7] = False
    elif kind == "dead":
        alive[:] = False
    tol = 8 * np.finfo(dtype).eps * np.abs(ds).max(axis=1)
    return ds.astype(dtype), us.astype(dtype), alive, tol.astype(dtype)


@pytest.mark.parametrize("kind", ["none", "some", "full", "dead"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_deflate_scan_plain_matches_numpy_transcription(kind, dtype):
    ds, us, alive, tol = _scan_case(kind, dtype)
    got = dc.deflate_scan(torch.tensor(ds), torch.tensor(us),
                          torch.tensor(alive), torch.tensor(tol))
    fields = ("fin_idx", "fin_d", "fin_u", "fin_valid", "rot_ip", "rot_i",
              "rot_c", "rot_s", "rot_m", "depths")
    n_rot = 0
    for b in range(ds.shape[0]):
        recs, carry = _scan_numpy(ds[b], us[b], alive[b], tol[b])
        for f, col in zip(fields, zip(*recs)):
            want = np.array(col, dtype=getattr(got, f).numpy().dtype)
            assert np.array_equal(getattr(got, f)[b].numpy(), want), f
        for f, val in zip(("has_p", "ip", "dp", "up"), carry):
            assert getattr(got, f)[b].item() == val, f
        n_rot += int(got.rot_m[b].sum())
    deepest = int(got.depths.max())
    if kind in ("none", "dead"):
        assert n_rot == 0 and deepest == -1
    elif kind == "some":
        assert n_rot > 0 and 0 <= deepest < 10
    else:
        assert deepest == ds.shape[1] - 2      # one chain through every pole


def test_deflate_scan_refuses_what_the_kernel_does_not_take():
    ds, us, alive, tol = (torch.tensor(x) for x in _scan_case("none",
                                                              np.float64))
    with pytest.raises(TypeError):
        dc.deflate_scan(ds.half(), us.half(), alive, tol.half())
    with pytest.raises(TypeError):
        dc.deflate_scan(ds, us, alive.int(), tol)
    with pytest.raises(ValueError):
        dc.deflate_scan(ds, us[:, :5], alive, tol)
    with pytest.raises(ValueError):
        dc.deflate_scan(ds, us, alive, tol[:1])


@pytest.mark.parametrize("n,levels", [(64, 0), (65, 1), (300, 3), (4096, 6)])
def test_tree_shape_matches_jax(n, levels):
    assert dc._tree_shape(n) == jax_dc._tree_shape(n)
    assert dc._tree_shape(n)[1] == levels


def test_tridiag_eigh_takes_dc_for_the_full_spectrum(monkeypatch):
    monkeypatch.delenv("EK_TRIDIAG", raising=False)
    rng = np.random.default_rng(11)
    n = 120
    d, e = rng.standard_normal(n), rng.standard_normal(n - 1)
    w, z = td.tridiag_eigh(torch.tensor(d), torch.tensor(e))
    w_dc, z_dc = dc.tridiag_dc(torch.tensor(d), torch.tensor(e))
    assert torch.equal(w, w_dc) and torch.equal(z, z_dc)
    w_j, _ = jax_tridiag_eigh(jnp.asarray(d), jnp.asarray(e))
    assert np.abs(w.numpy() - np.asarray(w_j)).max() < 5e-13 * np.abs(
        w.numpy()).max()


def test_dc_iters_env(monkeypatch):
    # EK_DC_ITERS overrides the Newton count: 60 in float64 and 30 in
    # float32 by default
    rng = np.random.default_rng(12)
    d, e = torch.tensor(rng.standard_normal(130)), \
        torch.tensor(rng.standard_normal(129))
    monkeypatch.delenv("EK_DC_ITERS", raising=False)
    w64 = dc.tridiag_dc(d, e)[0]
    w32 = dc.tridiag_dc(d.float(), e.float())[0]
    monkeypatch.setenv("EK_DC_ITERS", "60")
    assert torch.equal(dc.tridiag_dc(d, e)[0], w64)
    monkeypatch.setenv("EK_DC_ITERS", "30")
    assert torch.equal(dc.tridiag_dc(d.float(), e.float())[0], w32)
    monkeypatch.setenv("EK_DC_ITERS", "3")
    assert not torch.equal(dc.tridiag_dc(d, e)[0], w64)
