"""The port's tridiagonal eigensolver (bisection + inverse iteration)
against the JAX package's ``ops/tridiag.py::tridiag_eigh``.

On the CPU the JAX function counts with its associative minor scan and
solves with ``lax.scan``; the port runs the dstebz recurrence and the LU
sweep of its kernels.  Both bisect to 2^-iters of the span, but their
counts may round differently within a few ulps of an eigenvalue, so
eigenvalues are held to ``2^-iters span + 8 eps span``.  On clustered
spectra the JAX function's CPU scan is off by up to 1e-9 (the minor
products lose their sign inside a cluster); there the eigenvalues are held
against the Pallas Sturm kernel in interpret mode, which is what the JAX
package runs on its TPU, and against scipy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from eigenkernel_tpu.ops.pallas_sturm import sturm_bisect as jax_sturm_bisect
from eigenkernel_tpu.ops.tridiag import gershgorin_bounds as jax_bounds
from eigenkernel_tpu.ops.tridiag import tridiag_eigh as jax_tridiag_eigh
from eigenkernel_tpu_torch.ops import tridiag as td


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _eig_bar(d, e, dtype=np.float64):
    lo, hi = td.gershgorin_bounds(torch.tensor(d), torch.tensor(e))
    span = float(hi - lo)
    iters = 62 if dtype == np.float64 else 30
    return 2.0 ** -iters * span + 8 * np.finfo(dtype).eps * span


def _tmat(d, e):
    return np.diag(d) + np.diag(e, 1) + np.diag(e, -1)


def _port(d, e, k):
    w, v = td.tridiag_eigh(torch.tensor(d), torch.tensor(e), n_vec=k)
    return w.numpy(), v.numpy()


@pytest.mark.parametrize("n,k,seed", [(150, 20, 13), (97, 12, 2)])
def test_tridiag_eigh_matches_jax_separated(n, k, seed):
    rng = np.random.default_rng(seed)
    d, e = rng.standard_normal(n), rng.standard_normal(n - 1)
    w_ref, v_ref = jax_tridiag_eigh(jnp.asarray(d), jnp.asarray(e), n_vec=k)
    w, v = _port(d, e, k)
    assert np.abs(w - np.asarray(w_ref)).max() <= _eig_bar(d, e)
    overlap = np.abs(v.T @ np.asarray(v_ref))
    assert np.abs(overlap - np.eye(k)).max() <= 1e-9


def _degenerate_tridiag():
    # exactly repeated eigenvalues (test_dc.py::test_dc_degenerate_clusters)
    rng = np.random.default_rng(7)
    n = 128
    w_deg = np.repeat(np.arange(n // 4), 4).astype(float)
    qr, _ = np.linalg.qr(rng.standard_normal((n, n)))
    h = sla.hessenberg((qr * w_deg[None, :]) @ qr.T)
    return np.diag(h).copy(), np.diag(h, -1).copy()


def _glued_wilkinson():
    # test_dc.py::test_dc_adversarial: near-double pairs across blocks
    k = np.abs(np.arange(21) - 10).astype(float)
    d = np.tile(k, 6)
    e = np.ones(21 * 6 - 1)
    e[20::21] = 1e-8
    return d, e


@pytest.mark.parametrize("spectrum", ["degenerate", "glued"])
def test_tridiag_eigh_clustered(spectrum):
    d, e = _degenerate_tridiag() if spectrum == "degenerate" \
        else _glued_wilkinson()
    k = 40
    dj, ej = jnp.asarray(d), jnp.asarray(e)
    w_ref = jax_sturm_bisect(dj, ej, jnp.arange(k), *jax_bounds(dj, ej),
                             iters=62, interpret=True)
    w, v = _port(d, e, k)
    assert np.abs(w - np.asarray(w_ref)).max() <= _eig_bar(d, e)
    t = _tmat(d, e)
    scale = np.abs(np.linalg.eigvalsh(t)).max()
    assert np.abs(w - sla.eigvalsh_tridiagonal(d, e)[:k]).max() \
        <= 1e-13 * scale
    assert np.abs(t @ v - v * w[None, :]).max() <= 1e-12 * scale
    assert np.abs(v.T @ v - np.eye(k)).max() <= 1e-13 * k


def test_tridiag_eigh_full_spectrum_bisect(monkeypatch):
    monkeypatch.setenv("EK_TRIDIAG", "bisect")
    rng = np.random.default_rng(21)
    n = 60
    d, e = rng.standard_normal(n), rng.standard_normal(n - 1)
    w, v = _port(d, e, None)
    t = _tmat(d, e)
    assert np.abs(w - np.linalg.eigvalsh(t)).max() <= _eig_bar(d, e)
    assert np.abs(t @ v - v * w[None, :]).max() <= 1e-12
    assert np.abs(v.T @ v - np.eye(n)).max() <= 1e-12


def test_tridiag_eigh_float32():
    rng = np.random.default_rng(5)
    n, k = 96, 10
    d = rng.standard_normal(n).astype(np.float32)
    e = rng.standard_normal(n - 1).astype(np.float32)
    w, v = td.tridiag_eigh(torch.tensor(d), torch.tensor(e), n_vec=k)
    assert w.dtype == torch.float32 and v.dtype == torch.float32
    w_ref, _ = jax_tridiag_eigh(jnp.asarray(d), jnp.asarray(e), n_vec=k)
    assert np.abs(w.numpy() - np.asarray(w_ref)).max() \
        <= _eig_bar(d.astype(np.float64), e.astype(np.float64), np.float32)
    t = _tmat(d.astype(np.float64), e.astype(np.float64))
    v = v.double().numpy()
    assert np.abs(t @ v - v * w.double().numpy()[None, :]).max() <= 1e-4
    assert np.abs(v.T @ v - np.eye(k)).max() <= 1e-5


def test_tridiag_eigh_small_n_uses_eigh():
    rng = np.random.default_rng(8)
    d, e = rng.standard_normal(6), rng.standard_normal(5)
    w, v = _port(d, e, 4)
    w_ref, v_ref = jax_tridiag_eigh(jnp.asarray(d), jnp.asarray(e), n_vec=4)
    assert np.abs(w - np.asarray(w_ref)).max() <= 1e-14
    assert np.abs(np.abs(v.T @ np.asarray(v_ref)) - np.eye(4)).max() <= 1e-12


@pytest.mark.parametrize("env,k", [(None, None), ("dc", 5)])
def test_divide_and_conquer_branch_raises(monkeypatch, env, k):
    # the dc branch (auto at the full spectrum, or EK_TRIDIAG=dc for any
    # part of it) runs divide and conquer, as the JAX function does
    if env is None:
        monkeypatch.delenv("EK_TRIDIAG", raising=False)
    else:
        monkeypatch.setenv("EK_TRIDIAG", env)
    rng = np.random.default_rng(3)
    d, e = rng.standard_normal(20), rng.standard_normal(19)
    w, v = _port(d, e, k)
    kk = 20 if k is None else k
    w_ref, _ = jax_tridiag_eigh(jnp.asarray(d), jnp.asarray(e), n_vec=k)
    assert w.shape == (kk,) and v.shape == (20, kk)
    scale = np.abs(np.asarray(w_ref)).max()
    assert np.abs(w - np.asarray(w_ref)).max() <= 5e-13 * scale
    t = _tmat(d, e)
    assert np.abs(t @ v - v * w[None, :]).max() <= 5e-13 * scale
    assert np.abs(v.T @ v - np.eye(kk)).max() <= 1e-13


def test_zero_matrix_gets_a_positive_pivot_floor():
    n, k = 20, 5
    d, e = torch.zeros(n, dtype=torch.float64), torch.zeros(n - 1,
                                                            dtype=torch.float64)
    assert td.pivot_floor(d, e) == torch.finfo(torch.float64).eps
    w, v = td.tridiag_eigh(d, e, n_vec=k)
    assert np.abs(w.numpy()).max() <= 1e-300
    v = v.numpy()
    assert np.isfinite(v).all()
    assert np.abs(v.T @ v - np.eye(k)).max() <= 1e-13


def test_inverse_iteration_start_is_seeded():
    rng = np.random.default_rng(30)
    d, e = rng.standard_normal(50), rng.standard_normal(49)
    _, v1 = _port(d, e, 5)
    _, v2 = _port(d, e, 5)
    assert np.array_equal(v1, v2)


def test_cholqr2_raises_on_rank_deficient_block():
    v = torch.tensor(np.random.default_rng(1).standard_normal((30, 4)))
    v[:, 3] = 0.0                     # Gram matrix not positive definite
    with pytest.raises(ValueError, match="not positive definite"):
        td.cholqr2(v)


def test_gershgorin_sentinel_matches_jax():
    from eigenkernel_tpu.ops.blocked import gershgorin_sentinel as jax_sent
    from eigenkernel_tpu_torch.ops.blocked import gershgorin_sentinel

    rng = np.random.default_rng(12)
    a = rng.standard_normal((40, 40))
    a = (a + a.T) / 2
    mu = float(gershgorin_sentinel(torch.tensor(a)))
    assert mu == float(jax_sent(jnp.asarray(a)))
    assert mu > np.linalg.eigvalsh(a).max()
