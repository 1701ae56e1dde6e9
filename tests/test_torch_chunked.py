"""The sweep-range chase (``chase.band_to_tridiag_chunked``,
``EK_CHASE_CHUNKS``) and the chase on a process grid in ranges.

On the CPU the chase runs its plain version.  Within a sweep order
nothing changes, so the chunked chase must give the whole chase's bits
(``torch.equal``); against the JAX package's ``band_to_tridiag_chunked``
(its sequential chase, the same reflectors in another order of window-
disjoint steps) the port agrees to the bars of
``test_torch_twostage.py``: d and e to 1e-12 relative, the reflectors to
1e-11.  Grid runs are spawned gloo ranks (``torch_mesh_ranks.py``) on a
2 x 2 grid; the JAX package solves on a 2 x 2 mesh of the conftest's
virtual CPU devices.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from eigenkernel_tpu.ops import bulge as jax_bulge
from eigenkernel_tpu.parallel import mesh as jax_mesh
from eigenkernel_tpu.solvers.api import solve as jax_solve
from eigenkernel_tpu_torch.ops import bulge, chase


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _banded(n, bw, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    return np.triu(np.tril(a, bw), -bw)


@functools.lru_cache(maxsize=None)
def _whole(n, bw):
    bnd = torch.tensor(_banded(n, bw, n + bw))
    return bnd, chase.band_to_tridiag(bnd, bw)


@pytest.mark.parametrize("chunks", [1, 2, 4, 7])
@pytest.mark.parametrize("n,bw", [(67, 4), (67, 8), (130, 4), (130, 8)])
def test_chunked_chase_is_the_whole_chase_bit_for_bit(n, bw, chunks):
    bnd, whole = _whole(n, bw)
    before = chase.LAUNCHES
    got = chase.band_to_tridiag(bnd, bw, chunks)
    assert chase.LAUNCHES == before          # CPU tensors run the plain path
    for f in ("d", "e", "HV", "HT"):
        assert torch.equal(getattr(got, f), getattr(whole, f)), f
    # the ranges one at a time, each into a buffer of its own, handed on
    seen = []
    res = chase.band_to_tridiag_chunked(
        chase.lower_storage(bnd, bw), n, bw, chunks,
        keep=lambda c_lo, hv, ht: seen.append((c_lo, hv, ht)))
    assert res.HV is None and res.HT is None
    assert torch.equal(res.d, whole.d) and torch.equal(res.e, whole.e)
    assert [c for c, _, _ in seen] == [lo for lo, _ in
                                       chase.chase_ranges(n, bw, chunks)]
    assert torch.equal(torch.cat([hv for _, hv, _ in seen]), whole.HV[:n - 2])
    assert torch.equal(torch.cat([ht for _, _, ht in seen]), whole.HT[:n - 2])


@pytest.mark.parametrize("n,bw,chunks,group", [
    (67, 4, 4, 0), (130, 8, 7, 0), (4096, 64, 4, 0), (4096, 64, 4, 16),
    (16384, 64, 4, 0), (100, 8, 1, 0), (20, 8, 4, 0)])
def test_chase_ranges_cut_at_group_edges(n, bw, chunks, group):
    ranges = chase.chase_ranges(n, bw, chunks, group)
    g = bulge._group_size(group, bw)
    # contiguous, oldest first, the whole chase, at most `chunks` ranges
    assert ranges[0][0] == 0 and ranges[-1][1] == n - 3
    assert all(lo == hi + 1 for (_, hi), (lo, _) in zip(ranges, ranges[1:]))
    assert len(ranges) <= max(chunks, 1)
    # each range ends at a group's newest sweep and holds whole groups;
    # every range past the first has the same length, the first is short
    ends = {n - 3 - G * g for G in range(bulge.n_chase_groups(n, g))}
    assert all(hi in ends for _, hi in ranges)
    assert all((hi - lo + 1) % g == 0 for lo, hi in ranges[1:])
    lens = [hi - lo + 1 for lo, hi in ranges]
    assert len(set(lens[1:])) <= 1 and lens[0] <= lens[-1]


@pytest.mark.parametrize("n,bw", [(100, 8), (61, 5)])
def test_chunked_chase_matches_jax_chunked(n, bw):
    bnd = _banded(n, bw, 7 * n + bw)
    ref = jax_bulge.band_to_tridiag_chunked(jnp.asarray(bnd), bw, mesh=None,
                                            chunks=4)
    got = chase.band_to_tridiag(torch.tensor(bnd), bw, 4)
    scale = np.abs(np.asarray(ref.d)).max()
    assert np.abs(got.d.numpy() - np.asarray(ref.d)).max() <= 1e-12 * scale
    assert np.abs(got.e.numpy() - np.asarray(ref.e)).max() <= 1e-12 * scale
    assert got.HV.shape == tuple(ref.HV.shape)
    assert np.abs(got.HV.numpy() - np.asarray(ref.HV)).max() <= 1e-11
    assert np.abs(got.HT.numpy() - np.asarray(ref.HT)).max() <= 1e-11


def test_range_rejects_sweeps_outside_the_chase():
    lb = chase.lower_storage(torch.tensor(_banded(40, 4, 1)), 4)
    for lo, hi in ((-1, 3), (5, 4), (0, 38)):
        with pytest.raises(ValueError, match="outside"):
            chase.banded_to_tridiag_range(lb, 40, 4, lo, hi)


# ---- on a 2 x 2 grid -------------------------------------------------------

N_GRID, BW_GRID, GROUP = 72, 4, 4


@pytest.fixture(scope="module")
def store_checks(tmp_path_factory):
    bnd = _banded(N_GRID, BW_GRID, 5)
    lower = chase.lower_storage(torch.tensor(bnd), BW_GRID).numpy()
    d = tmp_path_factory.mktemp("chunked_store")
    ranks.run_ranks("chase_store_checks", 4, (2, 2), lower, N_GRID, BW_GRID,
                    GROUP, str(d), timeout=300)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]


@pytest.mark.parametrize("chunks", [4, 1])
def test_grid_chase_keeps_each_rank_its_own_groups(store_checks, chunks):
    n_groups = int(store_checks[0][f"c{chunks}/n_groups"])
    assert n_groups == bulge.n_chase_groups(N_GRID, GROUP) >= 8
    for rank, r in enumerate(store_checks):
        assert r[f"c{chunks}/groups"].tolist() == list(
            range(rank, n_groups, 4))
        assert r[f"c{chunks}/same"].all()         # one device's bits
        assert bool(r[f"c{chunks}/de_equal"])


def test_grid_chase_never_holds_the_whole_store(store_checks):
    # the largest tensor a rank made in the chase: one range of the store
    # in flight under 4 ranges, the whole (n - 2, T, b) store under 1
    T = chase.n_positions(N_GRID, BW_GRID)
    whole = (N_GRID - 2) * T * BW_GRID
    longest = max(hi - lo + 1 for lo, hi in
                  chase.chase_ranges(N_GRID, BW_GRID, 4, GROUP))
    for r in store_checks:
        assert int(r["c1/most"]) >= whole
        assert int(r["c4/most"]) <= longest * T * BW_GRID < whole // 2


def _pencil(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    m = rng.standard_normal((n, n))
    return (a + a.T) / 2, m @ m.T / n + np.eye(n)


def test_grid_general_elpa2_in_ranges_matches_one_range_and_jax(
        tmp_path_factory):
    # bandwidth 16 at n = 132: 9 groups of 16 sweeps in 3 ranges
    n = 131
    assert len(chase.chase_ranges(n + 1, 16, 4)) == 3
    a, b = _pencil(n, 61)
    cases = [(f"c{c}", "general_elpa2", None, "float64", a, b,
              {"EK_CHASE_CHUNKS": str(c)}, {"block_size": 16})
             for c in (4, 1)]
    d = tmp_path_factory.mktemp("chunked_solve")
    ranks.run_ranks("solve_cases", 4, (2, 2), cases, str(d), timeout=300)
    r = dict(np.load(d / "rank0.npz"))
    # the same chase bits, so the same solve bits
    assert np.array_equal(r["c4/w"], r["c1/w"])
    assert np.array_equal(r["c4/v"], r["c1/v"])
    _, mx, orth = r["c4/check"]
    assert mx <= 1e-12 and orth <= 1e-10
    mesh = jax_mesh.make_mesh((2, 2), jax.devices()[:4])
    ref = np.asarray(jax_solve(a, b, solver="general_elpa2", mesh=mesh,
                               block_size=16).values)
    norm2 = np.abs(np.linalg.eigvalsh(a)).max()
    assert np.abs(r["c4/w"] - ref).max() <= 1e-12 * norm2
