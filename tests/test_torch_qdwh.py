"""The port's QDWH spectral divide and conquer (``ops/qdwh.py``) against
the JAX package's ``ops/qdwh.py``, with the cases and tolerances of
``tests/test_qdwh.py``: the sign function to 1e-13, eigenvalues to 1e-13
of ||A||_2 (two recursion levels and ragged halves at n = 300, base 128),
a clustered spectrum whose splits inside a cluster must be refused, and a
block no sigma candidate splits.  The port recurses on exact sizes; the
JAX function on sentinel-padded buckets.
"""

import numpy as np
import pytest
import scipy.linalg as sla
import torch

from eigenkernel_tpu.ops import qdwh as jax_qdwh
from eigenkernel_tpu.solvers.api import solve as jax_solve
from eigenkernel_tpu_torch.ops import qdwh
from eigenkernel_tpu_torch.solvers.api import solve


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _sym(n, seed=0):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return (a + a.T) / 2


@pytest.mark.parametrize("l0", [1e-16, 1e-7, 0.3, 1.0])
def test_qdwh_weights_equal_jax(l0):
    assert qdwh.qdwh_weights(l0) == jax_qdwh.qdwh_weights(l0)


def test_sign_qdwh_matches_jax():
    a = _sym(96)
    w, q = np.linalg.eigh(a)
    s_ref = (q * np.sign(w)[None, :]) @ q.T
    s = qdwh.sign_qdwh(torch.tensor(a)).numpy()
    assert np.abs(s - np.asarray(jax_qdwh.sign_qdwh(a))).max() <= 1e-13
    assert np.abs(s - s_ref).max() <= 1e-13


def test_spectral_dc_two_levels_matches_jax(monkeypatch):
    n = 300
    a = _sym(n, seed=1)
    splits = []
    split = qdwh._split

    def counting(blk, *args):
        out = split(blk, *args)
        splits.append((blk.shape[0], None if out is None else out[2]))
        return out

    monkeypatch.setattr(qdwh, "_split", counting)
    w, v = (x.numpy() for x in qdwh.spectral_dc_eigh(torch.tensor(a),
                                                     base=128))
    w_j, _ = jax_qdwh.spectral_dc_eigh(a, base=128, block=128)
    w_ref = np.linalg.eigvalsh(a)
    s = np.abs(w_ref).max()
    # the top block and at least one ragged child split
    sizes = [m for m, k in splits if k is not None]
    assert sizes[0] == n and any(m not in (n, 128, 256) for m in sizes[1:])
    assert np.abs(w - np.asarray(w_j)).max() / s <= 1e-13
    assert np.abs(w - w_ref).max() / s <= 1e-13
    assert np.abs(a @ v - v * w[None, :]).max() / s <= 1e-12
    assert np.abs(v.T @ v - np.eye(n)).max() <= 1e-13


def test_spectral_dc_clustered():
    rng = np.random.default_rng(3)
    n = 320
    w_deg = np.repeat(np.arange(n // 8), 8).astype(float)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = (q * w_deg[None, :]) @ q.T
    a = (a + a.T) / 2
    w, v = (x.numpy() for x in qdwh.spectral_dc_eigh(torch.tensor(a),
                                                     base=64))
    w_j, _ = jax_qdwh.spectral_dc_eigh(a, base=64, block=64)
    assert np.abs(w - w_deg).max() <= 1e-12
    assert np.abs(w - np.asarray(w_j)).max() <= 1e-12
    assert np.abs(a @ v - v * w[None, :]).max() <= 1e-11
    assert np.abs(v.T @ v - np.eye(n)).max() <= 1e-12


def test_spectral_dc_unsplittable(monkeypatch):
    # a I + tiny noise (tests/test_qdwh.py's case): correct whether or not
    # a sigma splits it; then with every split refused, the block goes to
    # the dense base case after every sigma candidate was tried
    rng = np.random.default_rng(4)
    n = 300
    e = rng.standard_normal((n, n)) * 1e-13
    a = 3.0 * np.eye(n) + (e + e.T) / 2
    w, v = (x.numpy() for x in qdwh.spectral_dc_eigh(torch.tensor(a),
                                                     base=64))
    w_j, _ = jax_qdwh.spectral_dc_eigh(a, base=64, block=64)
    assert np.abs(w - 3.0).max() <= 1e-11
    assert np.abs(w - np.asarray(w_j)).max() <= 1e-11
    assert np.abs(v.T @ v - np.eye(n)).max() <= 1e-12
    sigmas = []
    monkeypatch.setattr(qdwh, "_split",
                        lambda blk, sigma, *args: sigmas.append(sigma))
    got = qdwh.spectral_dc_eigh(torch.tensor(a), base=64)
    want = torch.linalg.eigh(torch.tensor(a))
    assert len(sigmas) == len(qdwh._SIGMA_QUANTILES)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_spectral_dc_float32():
    n = 200
    a = _sym(n, seed=5).astype(np.float32)
    w, v = qdwh.spectral_dc_eigh(torch.tensor(a), base=64)
    assert w.dtype == torch.float32
    w_ref = np.linalg.eigvalsh(a.astype(np.float64))
    s = np.abs(w_ref).max()
    assert np.abs(w.double().numpy() - w_ref).max() / s <= 1e-4
    v = v.double().numpy()
    assert np.abs(v.T @ v - np.eye(n)).max() <= 1e-4


@pytest.mark.parametrize("solver", ["qdwh_dc", "general_qdwh_dc"])
def test_solve_matches_jax(solver):
    n = 96
    rng = np.random.default_rng(6)
    a = _sym(n, 6)
    m = rng.standard_normal((n, n)) * 0.1
    b = m @ m.T + np.eye(n) if solver.startswith("general") else None
    ref = jax_solve(a, b, solver=solver)
    got = solve(torch.tensor(a), None if b is None else torch.tensor(b),
                solver=solver)
    w, v = got.values.numpy(), got.vectors.numpy()
    assert got.meta["core"] == "qdwh" and v.shape == (n, n)
    assert np.abs(w - np.asarray(ref.values)).max() <= 1e-11
    assert np.abs(w - sla.eigh(a, b, eigvals_only=True)).max() <= 1e-11
    bv = v if b is None else b @ v
    assert np.abs(a @ v - bv * w).max() / np.linalg.norm(a) <= 1e-12
    assert np.abs(v.T @ bv - np.eye(n)).max() <= 1e-12
