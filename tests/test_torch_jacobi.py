"""The port's block-Jacobi core (``ops/jacobi.py``) against the JAX
package's ``ops/jacobi.py``.

On the CPU the pair eigh runs its plain version (``pair_eigh_plain``, the
arithmetic of kernel D2), held here to ``torch.linalg.eigh``; the card
tests (``tests/test_torch_cuda.py``) hold D2 to it bit for bit.  The
tolerances are those of ``tests/test_jacobi.py`` where a test has its
counterpart there: eigenvalues to 1e-12 between the packages (the port
pads a ragged n, the JAX function picks a smaller block), residual and
orthogonality to 1e-13 of ||A||_2.  Vectors are compared by residual and
orthogonality, never raw.  The panel is 16 wherever the default is not
the point: the plain pair eigh is a Python loop over sets and sweeps.
"""

import numpy as np
import pytest
import scipy.linalg as sla
import torch

from eigenkernel_tpu.ops import jacobi as jax_jacobi
from eigenkernel_tpu.solvers.api import solve as jax_solve
from eigenkernel_tpu_torch.ops import jacobi
from eigenkernel_tpu_torch.solvers.api import solve


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _sym(n, seed):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return (a + a.T) / 2


@pytest.mark.parametrize("nb", [2, 4, 6, 10])
def test_tournament_and_pair_rows_equal_jax(nb):
    t = jacobi._tournament(nb)
    assert np.array_equal(t, jax_jacobi._tournament(nb))
    assert np.array_equal(jacobi._pair_rows(t, 3),
                          jax_jacobi._pair_rows(t, 3))


@pytest.mark.parametrize("w", [1, 2, 3, 32, 33, 128])
def test_pair_sets_meet_every_pair_once_a_sweep(w):
    sets = jacobi.pair_sets(w)
    ww = w + (w & 1)
    assert sets.shape == (ww - 1, ww // 2, 2)
    assert (sets[..., 0] < sets[..., 1]).all()
    flat = [tuple(p) for p in sets.reshape(-1, 2)]
    assert len(set(flat)) == len(flat) == ww * (ww - 1) // 2
    for st in sets:                       # a set's pairs are disjoint
        assert len(set(st.reshape(-1))) == ww


def test_pair_eigh_plain_against_eigh():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((4, 32, 32))
    a = (a + a.transpose(0, 2, 1)) / 2
    got = jacobi.pair_eigh_plain(torch.tensor(a))
    w, v = got.values.numpy(), got.vectors.numpy()
    ref = np.linalg.eigvalsh(a)
    norm2 = np.abs(ref).max()
    assert np.abs(np.sort(w, axis=1) - ref).max() <= 1e-13 * norm2
    assert np.abs(v.transpose(0, 2, 1) @ v - np.eye(32)).max() <= 1e-14
    assert np.abs(a @ v - v * w[:, None, :]).max() <= 1e-13 * norm2
    assert (got.sweeps > 1).all() and (got.sweeps < jacobi.MAX_SWEEPS).all()
    # the last sweep rotated nothing: one more changes no bit
    again = jacobi.pair_eigh_plain(torch.tensor(a))
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("kind", ["diagonal", "degenerate", "odd"])
def test_pair_eigh_plain_edges(kind):
    rng = np.random.default_rng(1)
    if kind == "diagonal":                # nothing to rotate: one sweep
        a = np.stack([np.diag(rng.standard_normal(16)) for _ in range(3)])
    elif kind == "degenerate":            # repeated eigenvalues
        q, _ = np.linalg.qr(rng.standard_normal((16, 16)))
        lam = np.repeat([1.0, 2.0, -3.0, 0.5], 4)
        a = np.stack([(q * lam) @ q.T, np.eye(16)])
    else:                                 # odd w: a bye in every set
        a = rng.standard_normal((2, 17, 17))
        a = a + a.transpose(0, 2, 1)
    got = jacobi.pair_eigh_plain(torch.tensor(a))
    w, v = got.values.numpy(), got.vectors.numpy()
    n = a.shape[1]
    assert np.abs(v.transpose(0, 2, 1) @ v - np.eye(n)).max() <= 1e-14
    assert np.abs(np.sort(w, axis=1) - np.linalg.eigvalsh(a)).max() \
        <= 1e-13 * max(1.0, np.abs(a).max() * n)
    if kind == "diagonal":
        assert np.array_equal(v, np.broadcast_to(np.eye(n), v.shape))
        assert np.array_equal(w, np.diagonal(a, axis1=1, axis2=2))
        assert got.sweeps.tolist() == [1, 1, 1]
        assert got.rotations.tolist() == [0, 0, 0]
    if kind == "degenerate":
        assert got.rotations[1] == 0 and got.sweeps[1] == 1


def test_pair_eigh_takes_the_plain_version_on_the_cpu():
    a = torch.tensor(_sym(8, 2)).expand(3, 8, 8).contiguous()
    before = jacobi.LAUNCHES
    got = jacobi.pair_eigh(a)
    want = jacobi.pair_eigh_plain(a)
    assert jacobi.LAUNCHES == before
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    with pytest.raises(ValueError):
        jacobi.pair_eigh(a[:, :, :7])
    with pytest.raises(TypeError):
        jacobi.pair_eigh(a.to(torch.float16))


@pytest.mark.parametrize("n", [96, 100])
def test_block_jacobi_matches_jax(n):
    a = _sym(n, 3)
    w, v = (x.numpy() for x in jacobi.block_jacobi_eigh(torch.tensor(a),
                                                         block=16))
    w_j, _ = jax_jacobi.block_jacobi_eigh(a, block=16)
    norm2 = np.abs(np.linalg.eigvalsh(a)).max()
    assert v.shape == (n, n)
    assert np.abs(w - np.asarray(w_j)).max() <= 1e-12
    assert np.abs(w - np.linalg.eigvalsh(a)).max() <= 1e-13 * norm2
    assert np.abs(a @ v - v * w).max() <= 1e-13 * norm2
    assert np.abs(v.T @ v - np.eye(n)).max() <= 1e-13


def test_block_jacobi_degenerate_matches_jax():
    # repeated eigenvalues (tests/test_jacobi.py's permutation-cycle case)
    rng = np.random.default_rng(2)
    n = 64
    w_deg = np.repeat(np.arange(n // 4), 4).astype(float)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = (q * w_deg[None, :]) @ q.T
    w, v = (x.numpy() for x in jacobi.block_jacobi_eigh(torch.tensor(a),
                                                         block=8))
    w_j, _ = jax_jacobi.block_jacobi_eigh(a, block=8)
    assert np.abs(w - w_deg).max() <= 1e-12
    assert np.abs(w - np.asarray(w_j)).max() <= 1e-12
    assert np.abs(a @ v - v * w).max() <= 1e-12
    assert np.abs(v.T @ v - np.eye(n)).max() <= 1e-12


def test_block_jacobi_float32_and_tiny_n():
    a = _sym(40, 4)
    w, v = jacobi.block_jacobi_eigh(torch.tensor(a, dtype=torch.float32),
                                   block=8)
    assert w.dtype == torch.float32
    ref = np.linalg.eigvalsh(a)
    assert np.abs(w.double().numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    v = v.double().numpy()
    assert np.abs(v.T @ v - np.eye(40)).max() <= 1e-5
    for n in (1, 2, 3):                   # one block pair, padded or not
        a = _sym(n, n)
        w, v = (x.numpy() for x in jacobi.block_jacobi_eigh(torch.tensor(a)))
        assert np.abs(w - np.linalg.eigvalsh(a)).max() <= 1e-15 * n
        assert np.abs(a @ v - v * w).max() <= 1e-15 * n


@pytest.mark.parametrize("solver", ["jacobi", "general_jacobi"])
def test_solve_matches_jax(solver):
    n = 96
    rng = np.random.default_rng(5)
    a = _sym(n, 5)
    m = rng.standard_normal((n, n)) * 0.1
    b = m @ m.T + np.eye(n) if solver.startswith("general") else None
    ref = jax_solve(a, b, solver=solver, block_size=16)
    got = solve(torch.tensor(a), None if b is None else torch.tensor(b),
                solver=solver, block_size=16)
    w, v = got.values.numpy(), got.vectors.numpy()
    assert got.meta["core"] == "jacobi" and v.shape == (n, n)
    assert np.abs(w - np.asarray(ref.values)).max() <= 1e-11
    w_sp = sla.eigh(a, b, eigvals_only=True)
    assert np.abs(w - w_sp).max() <= 1e-11
    bv = v if b is None else b @ v
    assert np.abs(a @ v - bv * w).max() / np.linalg.norm(a) <= 1e-12
    assert np.abs(v.T @ bv - np.eye(n)).max() <= 1e-12
