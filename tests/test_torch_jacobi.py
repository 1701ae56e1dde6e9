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


def _set_params(a, r):
    """Kernel D2's parameter phase for set r of the block ``a`` (w x w,
    numpy): per circle-method pair (x, y), p = min, q = max, the rotation
    (c, s) and the flag (1 rotate, 0 skip, -1 bye)."""
    w, dt = a.shape[0], a.dtype.type
    x, y = jacobi._tournament(w + (w & 1))[r].T
    p, q = np.minimum(x, y), np.maximum(x, y)
    ap = np.pad(a, ((0, 1), (0, 1)))       # row and column w: the bye's
    app, aqq, apq = ap[p, p], ap[q, q], ap[p, q]
    with np.errstate(all="ignore"):
        thr = np.finfo(a.dtype).eps * np.sqrt(np.abs(app * aqq))
        tau = (aqq - app) / (dt(2) * apq)
        t = np.where(tau >= 0, dt(1), dt(-1)) / (
            np.abs(tau) + np.sqrt(dt(1) + tau * tau))
        c = dt(1) / np.sqrt(dt(1) + t * t)
        s = t * c
    f = np.where(q >= w, -1, (np.abs(apq) > thr).astype(int))
    return p, q, c, s, f


def _rows_then_columns(a, p, q, c, s, f):
    """The plain version's step: the rows of the rotating pairs, then
    their columns, then a_pq = a_qp = 0 for every pair but a bye."""
    x = np.pad(a, ((0, 1), (0, 1)))
    m = f == 1
    pm, qm, cm, sm = p[m], q[m], c[m], s[m]
    xp, xq = x[pm, :].copy(), x[qm, :].copy()
    x[pm, :] = cm[:, None] * xp - sm[:, None] * xq
    x[qm, :] = sm[:, None] * xp + cm[:, None] * xq
    xp, xq = x[:, pm].copy(), x[:, qm].copy()
    x[:, pm] = cm[None, :] * xp - sm[None, :] * xq
    x[:, qm] = sm[None, :] * xp + cm[None, :] * xq
    live = f >= 0
    x[p[live], q[live]] = 0
    x[q[live], p[live]] = 0
    return x[:-1, :-1]


def _xy(r, w):
    """The circle method's pairs (x, y) of set r, in the kernel's order."""
    return jacobi._tournament(w + (w & 1))[r].T


def _tiles(a, x, y, c, s, f):
    """The same step as kernel D2 takes it: for every pair of pairs (i, j)
    the 2 x 2 tile A[{x_i, y_i}, {x_j, y_j}] in the circle method's order,
    rotated by the rows of pair i and then by the columns of pair j from
    that tile's entries alone, with the signed sine (s where x < y, else
    -s), and a_pq = a_qp = 0 on the diagonal tiles (every tile at once)."""
    dt = a.dtype.type
    s = np.where(x < y, s, -s)
    b = np.pad(a, ((0, 1), (0, 1)))
    rows = (x[:, None], y[:, None])
    cols = (x[None, :], y[None, :])
    t = [[b[r, k] for k in cols] for r in rows]   # t[row][col]
    ri, ci, si = (f == 1)[:, None], c[:, None], s[:, None]
    t = [[np.where(ri, ci * t[0][k] - si * t[1][k], t[0][k]) for k in (0, 1)],
         [np.where(ri, si * t[0][k] + ci * t[1][k], t[1][k]) for k in (0, 1)]]
    rj, cj, sj = (f == 1)[None, :], c[None, :], s[None, :]
    t = [[np.where(rj, cj * t[r][0] - sj * t[r][1], t[r][0]),
          np.where(rj, sj * t[r][0] + cj * t[r][1], t[r][1])] for r in (0, 1)]
    diag = np.eye(len(f), dtype=bool) & (f >= 0)[:, None]
    t[0][1] = np.where(diag, dt(0), t[0][1])
    t[1][0] = np.where(diag, dt(0), t[1][0])
    for r in (0, 1):
        for k in (0, 1):
            b[rows[r], cols[k]] = t[r][k]
    return b[:-1, :-1]


def _pair_block(kind, w, dtype, seed):
    rng = np.random.default_rng(seed)
    if kind == "degenerate":              # eigenvalues in runs of 4
        qm, _ = np.linalg.qr(rng.standard_normal((w, w)))
        a = (qm * np.repeat(rng.standard_normal(-(-w // 4)), 4)[:w]) @ qm.T
        a = (a + a.T) / 2
    else:
        a = rng.standard_normal((w, w))
        a = a + a.T
    return a.astype(dtype)


@pytest.mark.parametrize("kind", ["random", "skips", "degenerate"])
@pytest.mark.parametrize("w", [16, 17])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_pair_set_as_tiles_matches_rows_then_columns(dtype, w, kind):
    # kernel D2's 2 x 2 tiles (row rotation, then column rotation, in the
    # tile) give the plain version's rows-then-columns step bit for bit,
    # for every set of a sweep: odd w has a bye in every set; "skips"
    # zeroes a_pq of every other pair, so diagonal tiles hold skipped
    # pairs beside rotated ones
    a = _pair_block(kind, w, dtype, seed=w)
    for r in range(w - 1 + (w & 1)):
        if kind == "skips":
            p, q = _set_params(a, r)[:2]
            a[p[::2], np.minimum(q[::2], w - 1)] = 0
            a[np.minimum(q[::2], w - 1), p[::2]] = 0
        p, q, c, s, f = _set_params(a, r)
        if kind == "skips":
            assert (f == 0).any() and (f == 1).any()
        got = _tiles(a, *_xy(r, w), c, s, f)
        want = _rows_then_columns(a, p, q, c, s, f)
        assert got.dtype == a.dtype and np.array_equal(got, want), r
        a = want


def _pair_eigh_tiles(a):
    """Kernel D2 for one block in numpy: the sets by tiles, V^T's rows by
    the same rotations, the stop rule and the counts of the kernel."""
    w = a.shape[0]
    vt = np.eye(w, dtype=a.dtype)
    sweeps = rotations = 0
    while sweeps < jacobi.MAX_SWEEPS:
        sweeps += 1
        in_sweep = 0
        for r in range(w - 1 + (w & 1)):
            x, y = _xy(r, w)
            c, s, f = _set_params(a, r)[2:]
            a = _tiles(a, x, y, c, s, f)
            m = f == 1                  # V^T's rows x, y, the signed sine
            x, y, c, s = x[m], y[m], c[m], np.where(x < y, s, -s)[m]
            vx, vy = vt[x, :].copy(), vt[y, :].copy()
            vt[x, :] = c[:, None] * vx - s[:, None] * vy
            vt[y, :] = s[:, None] * vx + c[:, None] * vy
            in_sweep += int(m.sum())
        rotations += in_sweep
        if in_sweep == 0:
            break
    return np.diagonal(a).copy(), vt.T, sweeps, rotations


@pytest.mark.parametrize("w", [8, 9])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_pair_eigh_by_tiles_matches_plain(dtype, w):
    # the whole kernel's order (parameters, tiles, V^T a set behind) on a
    # random, a degenerate and a diagonal block equals pair_eigh_plain
    blocks = np.stack([_pair_block("random", w, dtype, 1),
                       _pair_block("degenerate", w, dtype, 2),
                       np.diag(np.arange(w, dtype=dtype))])
    got = jacobi.pair_eigh_plain(torch.tensor(blocks))
    for b, blk in enumerate(blocks):
        vals, vecs, sweeps, rotations = _pair_eigh_tiles(blk.copy())
        assert np.array_equal(vals, got.values[b].numpy())
        assert np.array_equal(vecs, got.vectors[b].numpy())
        assert sweeps == got.sweeps[b] and rotations == got.rotations[b]
    assert got.rotations[2] == 0 and got.rotations[0] > 0


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
