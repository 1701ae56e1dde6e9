"""The modules of the port's generalized and two-stage grid paths on
their own, against the JAX package's functions on its mesh.

The grid runs go in spawned gloo ranks on 127.0.0.1
(``torch_mesh_ranks.py``), one thread each, with a join timeout: on a
2 x 2 grid at n = 128 and on a 1 x 4 grid at a ragged n = 130 (padded
to 132), the Cholesky factor, the inverse and the triangular solves
against the JAX functions on a 2 x 2 mesh of the conftest's virtual CPU
devices, within 1e-12; the three reductions and ``recover``; ``to_band``
(Q B Q^T = A, and the band equal to the single-device port's); the
products of ``parallel/mesh.py``; and the largest tensor a rank makes in
a ``general_elpa2`` pipeline, under the blocked back-transform and under
B4 (whose P stream phases are sized by n).  The chase's banded entry must equal its
dense entry bit for bit (the plain version on the CPU).
"""

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from eigenkernel_tpu.ops import blocked as jax_blocked
from eigenkernel_tpu.ops import reduction as jax_red
from eigenkernel_tpu.parallel import mesh as jax_mesh
from eigenkernel_tpu_torch.ops import band, chase, wf_bt
from eigenkernel_tpu_torch.ops.bulge import _to_banded

# (grid, n, panel width of the grid's Cholesky and solves, JAX block)
MODULES = [((2, 2), 128, 32, 32), ((1, 4), 130, 32, 256)]
BW = 8                       # to_band's bandwidth in the module runs


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _pencil(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    m = rng.standard_normal((n, n))
    return (a + a.T) / 2, m @ m.T / n + np.eye(n)


def _load(out_dir, world):
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def modules(tmp_path_factory):
    out = []
    for c, (shape, n, block, _) in enumerate(MODULES):
        rng = np.random.default_rng(60 + c)
        a, b = _pencil(n, 61 + c)
        n_m = -(-n // 4) * 4
        inputs = {"a": a, "b": b, "c": rng.standard_normal((n, n)),
                  "x": rng.standard_normal((n_m, 3)), "block": block,
                  "bw": BW}
        d = tmp_path_factory.mktemp(f"mod{c}")
        ranks.run_ranks("generalized_modules", 4, shape, inputs, str(d),
                        timeout=300)
        out.append((inputs, _load(d, 4)))
    return out


def _padded(x, n_m, eye=False):
    out = np.eye(n_m) if eye else np.zeros((n_m, n_m))
    out[:x.shape[0], :x.shape[1]] = x
    return out


@pytest.mark.parametrize("case", range(len(MODULES)))
def test_grid_products(modules, case):
    inputs, res = modules[case]
    r = res[0]
    n_m = int(r["n_m"])
    a = _padded(inputs["a"], n_m)
    c = _padded(inputs["c"], n_m)
    for other in res[1:]:          # whole and the same on every rank
        for key in ("mm", "mm_t", "c_t", "tall", "chol", "band/lower"):
            assert np.array_equal(other[key], r[key])
    scale = np.abs(a).max() * np.abs(c).max() * n_m
    assert np.abs(r["mm"] - a @ c).max() <= 1e-14 * scale
    assert np.abs(r["mm_t"] - a.T @ c.T).max() <= 1e-14 * scale
    part = np.zeros((n_m, n_m))
    part[3:n_m - 5, 7:] = a[3:n_m - 5, 2:n_m - 9] @ c[2:n_m - 9, 7:]
    assert np.abs(r["mm_part"] - part).max() <= 1e-14 * scale
    assert np.array_equal(r["c_t"], c.T)
    x = inputs["x"]
    tall = c[1:n_m - 2, 4:n_m - 1] @ x[4:n_m - 1]
    assert np.abs(r["tall"] - tall).max() <= 1e-14 * scale


@pytest.mark.parametrize("case", range(len(MODULES)))
@pytest.mark.parametrize("what", ["chol", "inv", "trsm", "trsm_t", "trsm_r"])
def test_grid_blocked_matches_jax_mesh(modules, case, what):
    shape, n, _, jblock = MODULES[case]
    inputs, res = modules[case]
    r = res[0]
    n_m = int(r["n_m"])
    mesh = jax_mesh.make_mesh((2, 2), jax.devices()[:4])
    a = jax_mesh.distribute(inputs["a"], mesh)
    l = jax_blocked.blocked_cholesky(jax_mesh.distribute(inputs["b"], mesh),
                                     block=jblock, mesh=mesh)
    kw = {"block": jblock, "mesh": mesh}
    ref = {"chol": lambda: l,
           "inv": lambda: jax_blocked.invert_lower_triangular(l, **kw),
           "trsm": lambda: jax_blocked.trsm_lower(l, a, **kw),
           "trsm_t": lambda: jax_blocked.trsm_lower(l, a, transpose=True,
                                                    **kw),
           "trsm_r": lambda: jax_blocked.trsm_right_lower_t(l, a, **kw)}
    want = np.asarray(ref[what]())
    got = r[what]
    assert np.abs(got[:n, :n] - want).max() <= 1e-12 * max(
        1.0, np.abs(want).max())
    # the padding: the factor and its inverse the identity there, the
    # solves of a zero-padded A zero
    pad = _padded(np.zeros((n, n)), n_m, eye=what in ("chol", "inv"))
    assert np.array_equal(got[n:], pad[n:])
    assert np.array_equal(got[:, n:], pad[:, n:])
    if what == "chol":
        assert np.array_equal(np.triu(got, 1), np.zeros((n_m, n_m)))


@pytest.mark.parametrize("case", range(len(MODULES)))
@pytest.mark.parametrize("style", ["scalapack", "scalapack_new", "elpa"])
def test_grid_reduction_matches_jax_mesh(modules, case, style):
    shape, n, _, jblock = MODULES[case]
    inputs, res = modules[case]
    mesh = jax_mesh.make_mesh((2, 2), jax.devices()[:4])
    fn = {"scalapack": jax_red.reduce_scalapack,
          "scalapack_new": jax_red.reduce_scalapack_new,
          "elpa": jax_red.reduce_elpa}[style]
    red = fn(jax_mesh.distribute(inputs["a"], mesh),
             jax_mesh.distribute(inputs["b"], mesh), block=jblock, mesh=mesh)
    want = np.asarray(red.a_std)
    x = np.asarray(jax_red.recover(red, jax_mesh.distribute(np.eye(n), mesh),
                                   block=jblock, mesh=mesh))
    for r in res:                       # every rank holds the same
        a_std, rec = r[f"{style}/a_std"], r[f"{style}/recover"]
        assert np.abs(a_std[:n, :n] - want).max() <= 1e-12 * np.abs(
            want).max()
        assert np.array_equal(a_std, a_std.T)
        assert not a_std[n:, :n].any()
        assert np.abs(rec[:n, :n] - x).max() <= 1e-12 * np.abs(x).max()
    # x = L^{-T} y is B-orthonormal
    rec = res[0][f"{style}/recover"][:n, :n]
    assert np.abs(rec.T @ inputs["b"] @ rec - np.eye(n)).max() <= 1e-12


def _dense_band(lower, n, bw):
    """The dense symmetric band of the storage ``lower`` (n + 2bw rows)."""
    out = np.zeros((n, n))
    for q in range(bw, 2 * bw + 1):
        d = lower[2 * bw - q:n, q]
        idx = np.arange(2 * bw - q, n)
        out[idx, idx - (2 * bw - q)] = d
        out[idx - (2 * bw - q), idx] = d
    return out


@pytest.mark.parametrize("case", range(len(MODULES)))
def test_grid_to_band(modules, case):
    inputs, res = modules[case]
    r = res[0]
    n_m = int(r["n_m"])
    a = _padded(inputs["a"], n_m)
    dense = _dense_band(r["band/lower"], n_m, BW)
    q = r["band/Q"]
    assert np.abs(q @ dense @ q.T - a).max() <= 1e-12 * np.abs(a).max()
    assert np.abs(q.T @ q - np.eye(n_m)).max() <= 1e-12
    one = band.to_band(torch.tensor(a), BW)
    assert np.abs(dense - one.band.numpy()).max() <= 1e-12 * np.abs(a).max()
    assert np.abs(r["band/taus"] - one.taus.numpy()).max() <= 1e-12
    # nothing outside the band, rows past n_m zero
    assert not r["band/lower"][:, :BW].any()
    assert not r["band/lower"][n_m:].any()
    # WY group i on rank i mod 4 only
    groups = len(band.wy_groups(n_m, BW, 4))
    assert groups >= 4
    for rank, other in enumerate(res):
        assert other["band/groups"].tolist() == [
            i for i in range(groups) if i % 4 == rank]


@pytest.mark.parametrize("case", range(len(MODULES)))
def test_grid_cholesky_breakdown_raises_on_every_rank(modules, case):
    for r in modules[case][1]:
        assert "not positive definite" in str(r["breakdown"])
        assert "leading minor 1 " in str(r["breakdown"])


@pytest.mark.parametrize("method", ["blocked", "wf_pallas"])
@pytest.mark.parametrize("case", range(len(MODULES)))
def test_grid_pipeline_holds_no_whole_matrix(modules, case, method):
    # general_elpa2 on the grid (the chase's store left out): no tensor a
    # rank made holds more than half the padded matrix, or under wf_pallas
    # one phase of B4's P stream, which holds n^2 / P words where one
    # composite step (nG S2^2 words) fits, and one step else (at this n)
    shape, n, block, _ = MODULES[case]
    for r in modules[case][1]:
        n_m = int(r["n_m"])
        most = n_m * n_m // 2
        if method == "wf_pallas":
            bw = block // 2
            pl = wf_bt.plan_of(n_m, bw, chase.n_positions(n_m, bw), 8, 0,
                               wf_bt.grid_stream_bytes(n_m, 8, 4))
            step = pl.nG * (pl.g + pl.m * pl.b) ** 2
            assert pl.tc == 1 or pl.tc * step <= n_m * n_m // 4
            most = max(most, pl.tc * step)
        assert 0 < int(r[f"largest/{method}"]) <= most


@pytest.mark.parametrize("n,parts", [(4096, 4), (4096, 2), (16384, 4)])
def test_grid_stream_phase_holds_a_share_of_n_squared(n, parts):
    # on a grid each rank builds B4's whole P stream, a phase at a time:
    # at the smoke's and the ROADMAP's sizes a phase holds at most
    # n^2 / P words, in more phases than one device's
    for itemsize in (8, 4):
        budget = wf_bt.grid_stream_bytes(n, itemsize, parts)
        pl = wf_bt.plan_of(n, 64, chase.n_positions(n, 64), itemsize, 0,
                           budget)
        one = wf_bt.plan_of(n, 64, chase.n_positions(n, 64), itemsize)
        phase = pl.tc * pl.nG * (pl.g + pl.m * pl.b) ** 2
        assert phase <= n * n // parts and pl.nph * pl.tc >= pl.Tq2
        assert pl.nph > one.nph


@pytest.mark.parametrize("case", range(len(MODULES)))
def test_banded_chase_of_grid_band_equals_dense_entry(modules, case):
    r = modules[case][1][0]
    n_m = int(r["n_m"])
    lower = torch.tensor(r["band/lower"])
    dense = torch.tensor(_dense_band(r["band/lower"], n_m, BW))
    assert torch.equal(chase.lower_storage(dense, BW), lower)
    one, two = chase.band_to_tridiag(dense, BW), \
        chase.banded_to_tridiag(lower, n_m, BW)
    for f in ("d", "e", "HV", "HT"):
        assert torch.equal(getattr(one, f), getattr(two, f))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,bw", [(2, 4), (1, 3), (9, 0), (40, 1), (97, 6),
                                  (150, 16)])
def test_banded_chase_entry_bit_for_bit(n, bw, dtype):
    g = torch.Generator().manual_seed(n + bw)
    a = torch.randn((n, n), generator=g, dtype=torch.float64)
    i = torch.arange(n)
    dense = torch.where((i[:, None] - i[None, :]).abs() <= bw, a + a.T,
                        0.0).to(dtype)
    lower = chase.lower_storage(dense, bw)
    assert torch.equal(lower[:n], _to_banded(dense, bw))
    before = lower.clone()
    one = chase.band_to_tridiag(dense, bw)
    two = chase.banded_to_tridiag(lower, n, bw)
    assert torch.equal(lower, before)            # the input is not changed
    for f in ("d", "e", "HV", "HT"):
        assert torch.equal(getattr(one, f), getattr(two, f))
    with pytest.raises(ValueError):
        chase.banded_to_tridiag(lower[:-1], n, bw)
