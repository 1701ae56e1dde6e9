"""The port's Householder tridiagonalization and WY back-transform against
the JAX package's ``ops/householder.py`` on the same float64 inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigenkernel_tpu.ops import householder as jhh
from eigenkernel_tpu_torch.convert import tridiag_from_numpy
from eigenkernel_tpu_torch.ops import householder as hh


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _sym(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    return (a + a.T) / 2


def _jax_block(n):
    # the JAX reduction needs n divisible by its panel; the port's last
    # panel may be ragged, so it always runs with 64
    return 65 if n == 130 else 64


@pytest.mark.parametrize("n", [1, 2, 3, 37, 128, 130])
def test_tridiagonalize_matches_jax(n):
    a = _sym(n, n)
    ref = jhh.tridiagonalize(jnp.asarray(a), block=_jax_block(n))
    launches = hh.LAUNCHES
    tri = hh.tridiagonalize(torch.tensor(a), block=64)
    assert hh.LAUNCHES == launches             # a CPU tensor launches no D4
    scale = np.linalg.norm(a)
    assert tri.d.shape == (n,) and tri.e.shape == (max(n - 1, 0),)
    assert np.abs(tri.d.numpy() - np.asarray(ref.d)).max() <= 1e-12 * scale
    if n > 1:
        assert np.abs(np.abs(tri.e.numpy()) - np.abs(np.asarray(ref.e))).max() \
            <= 1e-12 * scale
    # Q^T A Q = T with the port's own reflectors
    q = hh.apply_q(tri, torch.eye(n, dtype=torch.float64)).numpy()
    t = hh.tridiag_matrix(tri.d, tri.e).numpy()
    assert np.abs(q.T @ a @ q - t).max() <= 1e-12 * scale
    assert np.abs(q.T @ q - np.eye(n)).max() <= 1e-13 * max(n, 1)


@pytest.mark.parametrize("n,jblock", [(128, 64), (130, 65), (192, 32)])
def test_apply_q_on_jax_reflectors_matches_jax(n, jblock):
    a = _sym(n, 100 + n)
    ref_tri = jhh.tridiagonalize(jnp.asarray(a), block=jblock)
    z = np.random.default_rng(3).standard_normal((n, 7))
    ref = np.asarray(jhh.apply_q(ref_tri, jnp.asarray(z), block=jblock))
    tri = tridiag_from_numpy(*(np.asarray(x) for x in ref_tri),
                             device="cpu", dtype=torch.float64)
    got = hh.apply_q(tri, torch.tensor(z), block=64).numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def test_back_transform_of_tridiagonal_eigenvectors():
    # the true eigenvectors of T, back-transformed, are eigenvectors of A
    n = 150
    a = _sym(n, 9)
    tri = hh.tridiagonalize(torch.tensor(a), block=64)
    w, s = np.linalg.eigh(hh.tridiag_matrix(tri.d, tri.e).numpy())
    v = hh.apply_q(tri, torch.tensor(s)).numpy()
    assert np.abs(a @ v - v * w[None, :]).max() <= 1e-13 * np.linalg.norm(a)


def test_wy_t_factor_matches_jax_with_identity_reflector():
    rng = np.random.default_rng(4)
    m, b = 40, 6
    v = np.tril(rng.standard_normal((m, b)), k=-1)
    v[np.arange(b), np.arange(b)] = 1.0
    taus = 2.0 / (v * v).sum(axis=0)   # orthogonal reflectors
    v[:, 3] = 0.0                 # an identity reflector: zero column, tau 0
    taus[3] = 0.0
    ref = np.asarray(jhh.wy_t_factor(jnp.asarray(v), jnp.asarray(taus)))
    got = hh.wy_t_factor(torch.tensor(v), torch.tensor(taus)).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    # the factor reproduces the product of the reflectors
    h = np.eye(m)
    for j in range(b):
        h = h @ (np.eye(m) - taus[j] * np.outer(v[:, j], v[:, j]))
    assert np.abs(np.eye(m) - v @ got @ v.T - h).max() <= 1e-12
