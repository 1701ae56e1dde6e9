"""The port's kernel modules against the JAX package's Pallas kernels.

On CPU tensors ``ops/sturm.py`` and ``ops/tridiag_solve.py`` run their
plain PyTorch versions; they are held here against the Pallas kernels in
interpret mode (the way ``test_pallas_kernels.py`` runs them) on the same
numpy inputs.  The CUDA kernels themselves are compared with the plain
versions by ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from eigenkernel_tpu.ops.pallas_solve import tridiag_solve_pallas
from eigenkernel_tpu.ops.pallas_sturm import sturm_bisect as jax_sturm_bisect
from eigenkernel_tpu.ops.tridiag import gershgorin_bounds as jax_bounds
from eigenkernel_tpu_torch.ops import sturm, tridiag_solve
from eigenkernel_tpu_torch.ops.tridiag import gershgorin_bounds


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _rand_tridiag(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n), rng.standard_normal(n - 1)


def _degenerate():
    d = np.concatenate([np.full(30, 1.5), np.linspace(2, 3, 30)])
    return d, np.zeros(59)


# the four cases of test_pallas_kernels.py: (d, e, indices, dtype, scipy
# tol).  Against the Pallas kernel the bar is the bisection width
# 2^-iters span; against LAPACK it is those tests' own tolerances, since
# rounding in the Sturm counts, not the interval width, limits that match.
_STURM_CASES = {
    "full": (*_rand_tridiag(200, 0), np.arange(200), np.float64, 1e-11),
    "subset": (*_rand_tridiag(150, 3), np.arange(9), np.float64, 1e-11),
    "f32": (*_rand_tridiag(150, 3), np.arange(150), np.float32, 1e-4),
    "degenerate": (*_degenerate(), np.arange(60), np.float64, 1e-12),
}


@pytest.mark.parametrize("case", list(_STURM_CASES))
def test_sturm_bisect_matches_pallas(case):
    d, e, idx, dtype, scipy_tol = _STURM_CASES[case]
    iters = 62 if dtype == np.float64 else 30
    dj, ej = jnp.asarray(d, dtype), jnp.asarray(e, dtype)
    lo_j, hi_j = jax_bounds(dj, ej)
    ref_jax = np.asarray(jax_sturm_bisect(dj, ej, jnp.asarray(idx), lo_j,
                                          hi_j, iters=iters, interpret=True))
    td = torch.tensor(d.astype(dtype))
    te = torch.tensor(e.astype(dtype))
    lo, hi = gershgorin_bounds(td, te)
    before = sturm.LAUNCHES
    lam = sturm.sturm_bisect(td, te, torch.tensor(idx, dtype=torch.int32),
                             lo, hi, iters).numpy()
    assert sturm.LAUNCHES == before          # CPU tensors run the plain path
    span = float(hi - lo)
    assert np.abs(lam - ref_jax).max() <= 2.0 ** -iters * span
    ref = sla.eigvalsh_tridiagonal(d, e) if case != "degenerate" \
        else np.sort(d)
    assert np.abs(lam - ref[idx]).max() < scipy_tol


def _tree_case(case, dtype):
    d, e = _degenerate() if case == "degenerate" else _rand_tridiag(45, 8)
    n = d.shape[0]
    idx = (np.arange(11) * 7) % n                    # k odd, out of order
    td, te = torch.tensor(d.astype(dtype)), torch.tensor(e.astype(dtype))
    return td, te, torch.tensor(idx, dtype=torch.int32), idx


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("iters", [7, 13])
def test_sturm_bisect_matches_pallas_bitwise(iters, dtype):
    # depths that 5 (the kernel's pass) does not divide; odd k.  From the
    # same bounds the plain version and the Pallas kernel agree bit for bit
    td, te, ti, idx = _tree_case("random", dtype)
    lo, hi = gershgorin_bounds(td, te)
    lam = sturm.sturm_bisect(td, te, ti, lo, hi, iters).numpy()
    ref = np.asarray(jax_sturm_bisect(
        jnp.asarray(td.numpy()), jnp.asarray(te.numpy()), jnp.asarray(idx),
        jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy()), iters=iters,
        interpret=True))
    assert lam.dtype == ref.dtype and np.array_equal(lam, ref)


@pytest.mark.parametrize("case", ["random", "degenerate"])
@pytest.mark.parametrize("depth", [5, 6])
@pytest.mark.parametrize("iters,dtype", [(7, np.float64), (13, np.float64),
                                         (62, np.float64), (30, np.float32)])
def test_kernel_passes_pick_the_intervals_of_bisection(iters, dtype, depth,
                                                       case):
    # the kernel's schedule (a tree of 2^depth - 1 counts per pass, walked
    # level by level) ends every pass on the interval one-step bisection
    # reaches after as many steps, to the last bit
    td, te, ti, _ = _tree_case(case, dtype)
    lo, hi = gershgorin_bounds(td, te)
    steps = sturm.bisection_rounds(td, te, ti, lo, hi, iters, depth=1)
    passes = sturm.bisection_rounds(td, te, ti, lo, hi, iters, depth)
    walks = sturm.round_depths(iters, depth)
    assert len(passes) == -(-iters // depth) and sum(walks) == iters
    for (p_lo, p_hi), done in zip(passes, np.cumsum(walks)):
        s_lo, s_hi = steps[done - 1]
        assert torch.equal(p_lo, s_lo) and torch.equal(p_hi, s_hi)
    lam = 0.5 * (passes[-1][0] + passes[-1][1])
    assert torch.equal(lam, sturm.sturm_bisect_plain(td, te, ti, lo, hi,
                                                     iters))


def test_tree_node_indexing():
    assert [sturm.tree_node(j) for j in (0, 1, 2, 3, 6, 30, 31, 62)] == [
        (0, 0), (1, 0), (1, 1), (2, 0), (2, 3), (4, 15), (5, 0), (5, 31)]
    for j in range(63):
        level, pos = sturm.tree_node(j)
        assert sturm.tree_node(2 * j + 1) == (level + 1, 2 * pos)
        assert sturm.tree_node(2 * j + 2) == (level + 1, 2 * pos + 1)
    assert [sturm.depth_of(w) for w in (1, sturm.MAX_WARPS)] == [5, 6]
    assert sturm.round_depths(62, 5) == [5] * 12 + [2]
    assert sturm.round_depths(30, 5) == [5] * 6
    assert sturm.round_depths(62, 6) == [6] * 10 + [2]
    assert sturm.round_depths(30, 6) == [6] * 5
    assert sturm.round_depths(3, 5) == [3]
    # a node's point lies strictly inside the interval, in heap order
    pts = sturm.node_points(torch.tensor([0.0]), torch.tensor([1.0]), 3)
    assert pts[:, 0].tolist() == [0.5, 0.25, 0.75, 0.125, 0.375, 0.625,
                                  0.875]


@pytest.mark.parametrize("k,sms,warps", [
    (500, 132, 2), (1, 132, 2), (132, 132, 2), (264, 132, 2),
    (528, 132, 2), (529, 132, 1), (4096, 132, 1), (32, 8, 2), (33, 8, 1),
    (500, 8, 1)])
def test_warps_per_target_fill_the_card(k, sms, warps):
    # 2 warps a target while k blocks keep within 8 warps an SM, else 1
    assert sturm.WARPS_PER_SM == 8 and sturm.MAX_WARPS == 2
    assert sturm.warps_per_target(k, sms) == warps


@pytest.mark.parametrize("n,k,dtype,tol", [
    (300, 20, np.float64, 1e-12),
    (257, 3, np.float64, 1e-12),
    (300, 20, np.float32, 1e-4),
    (257, 3, np.float32, 1e-4),
])
def test_tridiag_solve_matches_pallas(n, k, dtype, tol):
    rng = np.random.default_rng(1)
    d = rng.standard_normal(n).astype(dtype)
    e = rng.standard_normal(n - 1).astype(dtype)
    lam = (rng.standard_normal(k) * 0.1).astype(dtype)
    b = rng.standard_normal((n, k)).astype(dtype)
    ref = np.asarray(tridiag_solve_pallas(
        jnp.asarray(d), jnp.asarray(e), jnp.asarray(lam), jnp.asarray(b),
        interpret=True))
    tiny = 1e-30 if dtype == np.float64 else 1e-25   # pallas_solve's floor
    before = tridiag_solve.LAUNCHES
    x = tridiag_solve.tridiag_solve(torch.tensor(d), torch.tensor(e),
                                    torch.tensor(lam), torch.tensor(b), tiny)
    assert tridiag_solve.LAUNCHES == before
    x = x.numpy()
    assert np.abs(x - ref).max() <= tol * np.abs(ref).max()
    # and it solves the systems
    t = np.diag(d.astype(np.float64)) + np.diag(e.astype(np.float64), 1) \
        + np.diag(e.astype(np.float64), -1)
    r = t @ x - x * lam[None, :].astype(np.float64) - b
    assert np.abs(r).max() <= 50 * tol * np.abs(x).max()


def test_wrappers_refuse_what_the_kernels_do_not_take():
    d = torch.zeros(5, dtype=torch.float64)
    e = torch.zeros(4, dtype=torch.float64)
    lo, hi = torch.tensor(-1.0, dtype=torch.float64), \
        torch.tensor(1.0, dtype=torch.float64)
    idx = torch.arange(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        sturm.sturm_bisect(d, e, idx.long(), lo, hi, 10)
    with pytest.raises(TypeError):
        sturm.sturm_bisect(d.half(), e.half(), idx, lo.half(), hi.half(), 10)
    with pytest.raises(ValueError):
        sturm.sturm_bisect(d, e[:3], idx, lo, hi, 10)
    b = torch.zeros((5, 3), dtype=torch.float64)
    lam = torch.zeros(3, dtype=torch.float64)
    with pytest.raises(ValueError):
        tridiag_solve.tridiag_solve(d, e, lam[:2], b, 1e-30)
    with pytest.raises(TypeError):
        tridiag_solve.tridiag_solve(d, e, lam.float(), b, 1e-30)
    with pytest.raises(ValueError):
        tridiag_solve.tridiag_solve(d, e, lam, b, 0.0)
    # a device that is neither the CPU nor CUDA is refused, not run plain
    meta = [t.to("meta") for t in (d, e, lam, b)]
    with pytest.raises(ValueError):
        tridiag_solve.tridiag_solve(*meta, 1e-30)
    with pytest.raises(ValueError):
        sturm.sturm_bisect(d.to("meta"), e.to("meta"), idx.to("meta"),
                           lo.to("meta"), hi.to("meta"), 10)
