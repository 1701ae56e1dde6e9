"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device (the kernels have no CPU mode) and
skips without one.  The file imports neither jax nor the JAX package, so
it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import torch_mesh_ranks as ranks

from eigenkernel_tpu_torch.ops import (backtransform, band, build, bulge,
                                       chase, dc, jacobi, sturm,
                                       tridiag_solve, wf_bt)
from eigenkernel_tpu_torch.ops.tridiag import gershgorin_bounds, pivot_floor


def _rand_tridiag(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n), rng.standard_normal(n - 1)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _sturm_input(spectrum, k, dtype, device):
    if spectrum == "degenerate":           # repeated d, zero e
        d_np = np.concatenate([np.full(30, 1.5), np.linspace(2, 3, 30)])
        e_np = np.zeros(59)
    else:
        d_np, e_np = _rand_tridiag(700, 5)
    n = d_np.shape[0]
    idx = (np.arange(k) * 7) % n          # out of order, repeats past n
    return (torch.tensor(d_np, dtype=dtype, device=device),
            torch.tensor(e_np, dtype=dtype, device=device),
            torch.tensor(idx, dtype=torch.int32, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("spectrum", ["random", "degenerate"])
@pytest.mark.parametrize("k", [1, 33, 500])
@pytest.mark.parametrize("dtype,iters", [(torch.float64, 62),
                                         (torch.float32, 30),
                                         (torch.float64, 7),
                                         (torch.float32, 7)])
def test_sturm_kernel_matches_plain_on_card(cuda_device, dtype, iters, k,
                                            spectrum):
    # the kernel counts at the points one-step bisection visits, several
    # levels a pass: the same bits, at depths the pass does not divide
    d, e, idx = _sturm_input(spectrum, k, dtype, cuda_device)
    lo, hi = gershgorin_bounds(d, e)
    before = sturm.LAUNCHES
    lam = sturm.sturm_bisect(d, e, idx, lo, hi, iters)
    torch.cuda.synchronize()
    assert sturm.LAUNCHES == before + 1
    assert torch.equal(lam, sturm.sturm_bisect_plain(d, e, idx, lo, hi,
                                                     iters))


@pytest.mark.cuda
@pytest.mark.parametrize("warps", [1, sturm.MAX_WARPS])
@pytest.mark.parametrize("dtype,iters", [(torch.float64, 62),
                                         (torch.float32, 13)])
def test_sturm_kernel_tree_depths_on_card(cuda_device, warps, dtype, iters):
    # 1 or 2 warps a target: trees of depth 5 or 6 a pass
    d, e, idx = _sturm_input("random", 37, dtype, cuda_device)
    lo, hi = gershgorin_bounds(d, e)
    lam = sturm._launch(d, e, idx, lo, hi, iters, warps)
    torch.cuda.synchronize()
    assert torch.equal(lam, sturm.sturm_bisect_plain(d, e, idx, lo, hi,
                                                     iters))


@pytest.mark.cuda
def test_layouts_match_kernel_sources(cuda_device):
    # the Python copies of the kernels' layout constants, which the tests
    # above take their edge cases from, are the sources' own
    from eigenkernel_tpu_torch.ops import build

    lib = build.library()
    assert lib.ek_sturm_max_warps() == sturm.MAX_WARPS
    assert lib.ek_tridiag_solve_rows() == tridiag_solve.ROWS
    for isz in (8, 4):
        for b, g, nc in ((3, 1, 8), (64, 64, 8), (64, 32, 16), (130, 16, 16),
                         (16, 5, 4), (64, 32, 4), (5, 5, 8)):
            assert lib.ek_chase_bt_smem(isz, b, g, nc) == \
                backtransform.smem_bytes(isz, b, g, nc)
    d, e, idx = _sturm_input("random", 3, torch.float64, cuda_device)
    lo, hi = gershgorin_bounds(d, e)
    with pytest.raises(build.KernelLaunchError):
        sturm._launch(d, e, idx, lo, hi, 62, 2 * sturm.MAX_WARPS)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 31, 33, 130])
@pytest.mark.parametrize("n", [1, 2, tridiag_solve.ROWS - 1,
                               tridiag_solve.ROWS + 1, 513])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_solve_kernel_matches_plain_on_card(cuda_device, dtype, n, k):
    # ragged last chunk (n = 1, R +- 1) and last warp (k = 1, 31, 33,
    # 130); k = 31 and 33 take single-element copies, k = 1 too in float64
    rng = np.random.default_rng(2)
    args = [torch.tensor(x, dtype=dtype, device=cuda_device) for x in (
        rng.standard_normal(n), rng.standard_normal(n - 1),
        rng.standard_normal(k) * 0.1, rng.standard_normal((n, k)))]
    # pallas_solve's absolute floor, and the one inverse iteration passes
    for tiny in (1e-30 if dtype == torch.float64 else 1e-25,
                 pivot_floor(args[0], args[1])):
        before = tridiag_solve.LAUNCHES
        x = tridiag_solve.tridiag_solve(*args, tiny)
        torch.cuda.synchronize()
        assert tridiag_solve.LAUNCHES == before + 1
        plain = tridiag_solve.tridiag_solve_plain(*args, tiny)
        assert torch.equal(x, plain)      # same roundings, no fused products


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_solve_kernel_unaligned_rhs_on_card(cuda_device, dtype):
    # b one element past a 16-byte boundary: single-element copies though
    # k is a multiple of the 16-byte vector
    rng = np.random.default_rng(4)
    n, k = 200, 128
    flat = torch.tensor(rng.standard_normal(n * k + 1), dtype=dtype,
                        device=cuda_device)
    b = flat[1:].view(n, k)
    assert b.is_contiguous() and b.data_ptr() % 16 != 0
    d, e, lam = (torch.tensor(x, dtype=dtype, device=cuda_device) for x in (
        rng.standard_normal(n), rng.standard_normal(n - 1),
        rng.standard_normal(k) * 0.1))
    tiny = pivot_floor(d, e)
    x = tridiag_solve.tridiag_solve(d, e, lam, b, tiny)
    torch.cuda.synchronize()
    assert torch.equal(x, tridiag_solve.tridiag_solve_plain(d, e, lam, b,
                                                            tiny))


@pytest.mark.cuda
def test_selecting_solve_on_card_launches_both_kernels(cuda_device):
    from eigenkernel_tpu_torch.solvers import solve

    rng = np.random.default_rng(3)
    a = rng.standard_normal((300, 300))
    a = (a + a.T) / 2
    sturm.LAUNCHES = tridiag_solve.LAUNCHES = 0
    pairs = solve(torch.tensor(a, device=cuda_device),
                  solver="scalapack_select", n_vec=12)
    assert sturm.LAUNCHES > 0 and tridiag_solve.LAUNCHES > 0
    w = pairs.values.cpu().numpy()
    v = pairs.vectors.cpu().numpy()
    assert np.abs(w - np.linalg.eigvalsh(a)[:12]).max() <= 1e-12 * 30
    assert np.abs(a @ v - v * w[None, :]).max() <= 1e-12 * 30


def _chase_input(n, bw, seed, dtype, device):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    a = np.triu(np.tril(a + a.T, bw), -bw)
    return torch.tensor(a, dtype=dtype, device=device)


def _spectrum(res):
    d = res.d.double().cpu().numpy()
    e = res.e.double().cpu().numpy()
    return np.linalg.eigvalsh(np.diag(d) + np.diag(e, 1) + np.diag(e, -1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,bw", [(300, 8), (257, 64), (97, 3)])
def test_chase_kernel_matches_plain_on_card(cuda_device, dtype, n, bw):
    bnd = _chase_input(n, bw, n + bw, dtype, cuda_device)
    before = chase.LAUNCHES
    got = chase.band_to_tridiag(bnd, bw)
    torch.cuda.synchronize()
    assert chase.LAUNCHES > before
    plain = chase.band_to_tridiag_plain(bnd, bw)
    lam = np.linalg.eigvalsh(bnd.double().cpu().numpy())
    scale = np.abs(lam).max()
    f64 = dtype == torch.float64
    # the spectrum is the invariant; in float64 d and e also agree, up to
    # the rounding-order drift along the chase
    bar = 1e-12 if f64 else 5e-5
    assert np.abs(_spectrum(got) - lam).max() <= bar * scale
    assert np.abs(_spectrum(got) - _spectrum(plain)).max() <= bar * scale
    if f64:
        assert float((got.d - plain.d).abs().max()) <= 1e-10 * scale
        assert float((got.e - plain.e).abs().max()) <= 1e-10 * scale
        assert float((got.HT - plain.HT).abs().max()) <= 1e-8


def _check_chase(got, bnd, dtype):
    plain = chase.band_to_tridiag_plain(bnd, got.bw)
    lam = np.linalg.eigvalsh(bnd.double().cpu().numpy())
    scale = np.abs(lam).max()
    bar = 1e-12 if dtype == torch.float64 else 5e-5
    assert np.abs(_spectrum(got) - lam).max() <= bar * scale
    assert np.abs(_spectrum(got) - _spectrum(plain)).max() <= bar * scale
    if dtype == torch.float64:
        assert float((got.d - plain.d).abs().max()) <= 1e-10 * scale
        assert float((got.e - plain.e).abs().max()) <= 1e-10 * scale
        assert float((got.HT - plain.HT).abs().max()) <= 1e-8


@pytest.mark.cuda
def test_chase_global_branch_past_the_window_limit_on_card(cuda_device):
    # b = 128 in float64: a lane's window needs 267 KB, more than a block has
    n, bw, dtype = 600, 128, torch.float64
    assert chase.branch(bw, dtype) == "global"
    bnd = _chase_input(n, bw, 11, dtype, cuda_device)
    before = chase.LAUNCHES
    got = chase.band_to_tridiag(bnd, bw)
    torch.cuda.synchronize()
    assert chase.LAUNCHES == before + 1
    assert chase.BRANCH == "global"
    _check_chase(got, bnd, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_chase_ctas_stride_over_lanes_on_card(cuda_device, monkeypatch,
                                              dtype):
    # n = 600, b = 8: up to 20 lanes a step on 3 CTAs
    n, bw = 600, 8
    monkeypatch.setattr(chase, "GRID_CAP", 3)
    assert chase.max_lanes(n, bw) > 3
    bnd = _chase_input(n, bw, 12, dtype, cuda_device)
    got = chase.band_to_tridiag(bnd, bw)
    torch.cuda.synchronize()
    assert chase.GRID == 3 and chase.BRANCH == "window"
    _check_chase(got, bnd, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,bw,g,k", [(200, 8, 0, 1), (200, 8, 0, 33),
                                      (200, 8, 0, 130), (200, 3, 7, 70),
                                      (200, 3, 7, 33), (300, 100, 64, 33),
                                      (300, 100, 64, 130)])
def test_wf_bt_kernel_edges_on_card(cuda_device, monkeypatch, dtype, n, bw,
                                    g, k):
    # k = 1, odd k and k past one column tile; S2 = 127 (b = 3, g = 7);
    # S2 = 164 (b = 100, g = 64) runs the streamed branch
    monkeypatch.delenv("EK_BT_GROUP", raising=False)
    res = chase.band_to_tridiag_plain(
        _chase_input(n, bw, n + k, dtype, cuda_device), bw)
    z = torch.tensor(np.random.default_rng(k).standard_normal((n, k)),
                     dtype=dtype, device=cuda_device)
    pl = wf_bt.plan(res, z, g)
    if g == 7:
        assert pl.g + pl.m * pl.b == 127
    before = wf_bt.LAUNCHES
    got = wf_bt.apply_chase_q_wavefront(res, z, g)
    torch.cuda.synchronize()
    assert wf_bt.LAUNCHES > before
    S2 = pl.g + pl.m * pl.b
    assert wf_bt.BRANCH == ("resident" if S2 <= 128 else "streamed")
    ref = wf_bt.apply_chase_q_wavefront_plain(res, z, g)
    bar = 1e-12 if dtype == torch.float64 else 5e-6
    scale = float(ref.abs().max())
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= bar * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,bw,g,m,nbytes", [
    (300, 8, 0, 8, wf_bt.STREAM_BYTES), (257, 16, 40, 5, 200000),
    (130, 3, 5, 41, 10 ** 9), (300, 64, 0, 1, wf_bt.STREAM_BYTES)])
def test_back_transform_kernels_match_plain_on_card(cuda_device, monkeypatch,
                                                    dtype, n, bw, g, m,
                                                    nbytes):
    # m: the composition depth that the rule gives for this b and g
    monkeypatch.delenv("EK_BT_GROUP", raising=False)
    monkeypatch.setattr(wf_bt, "STREAM_BYTES", nbytes)
    res = chase.band_to_tridiag_plain(
        _chase_input(n, bw, n, dtype, cuda_device), bw)
    z = torch.tensor(np.random.default_rng(1).standard_normal((n, 70)),
                     dtype=dtype, device=cuda_device)
    ref = bulge.apply_chase_q(res, z)
    scale = float(ref.abs().max())
    bar = 1e-12 if dtype == torch.float64 else 5e-6
    assert wf_bt.plan(res, z, g).m == m
    before = (wf_bt.LAUNCHES, backtransform.LAUNCHES)
    z4 = wf_bt.apply_chase_q_wavefront(res, z, g)
    z5 = backtransform.apply_chase_q_sweeps(res, z)
    torch.cuda.synchronize()
    assert wf_bt.LAUNCHES > before[0]
    assert backtransform.LAUNCHES == before[1] + 2     # factors, then walk
    z4p = wf_bt.apply_chase_q_wavefront_plain(res, z, g)
    assert float((z4 - z4p).abs().max()) <= bar * scale
    assert float((z4 - ref).abs().max()) <= bar * scale
    assert float((z5 - ref).abs().max()) <= bar * scale


def _chase_bt_input(n, bw, k, dtype, device, zero_cols):
    """The plain chase of a random band with the given columns (and rows)
    zeroed, which leaves windows of tau = 0 reflectors, and z (n, k)."""
    rng = np.random.default_rng(n + bw + k)
    a = rng.standard_normal((n, n))
    a = np.triu(np.tril(a + a.T, bw), -bw)
    for c in zero_cols:
        a[c, :] = 0
        a[:, c] = 0
    res = chase.band_to_tridiag_plain(torch.tensor(a, dtype=dtype,
                                                   device=device), bw)
    z = torch.tensor(rng.standard_normal((n, k)), dtype=dtype, device=device)
    return res, z


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,bw,g,k,nc,zero_cols", [
    (5, 3, 1, 7, 0, ()), (5, 3, 5, 1, 0, ()),
    (130, 8, 5, 70, 4, (10, 11)), (130, 16, 1, 130, 16, ()),
    (257, 16, 32, 7, 0, (100,)), (257, 3, 5, 130, 16, (40, 41, 42)),
    (257, 64, 32, 70, 8, ()), (300, 64, 64, 130, 4, (7, 150)),
    (300, 64, 16, 128, 8, ()), (300, 8, 32, 1, 0, (0, 299)),
    (257, 16, 16, 70, 16, (3,)), (300, 96, 64, 33, 0, (40,)),
    (260, 5, 5, 130, 8, ())])
def test_chase_bt_kernel_matches_plain_on_card(cuda_device, dtype, n, bw, g,
                                               k, nc, zero_cols):
    # g = 1, 5, 32, 64 (clamped to b: 5 -> 3, 32 -> 16 or 8); n - 2 not a
    # multiple of g (a partial last group); k = 1, odd, past one tile, a
    # multiple of the 16-byte vector; tiles of 4, 8 and 16 columns (the
    # plan's pick at these k is 4); odd b (no 16-byte copies of the
    # reflectors); b = 96, g = 64; zeroed
    # band columns give windows of tau = 0
    res, z = _chase_bt_input(n, bw, k, dtype, cuda_device, zero_cols)
    if zero_cols:
        assert bool((res.HT[:n - 2] == 0).any())
    before = backtransform.LAUNCHES
    got = backtransform._launch(res, z, g, nc)
    torch.cuda.synchronize()
    assert backtransform.LAUNCHES == before + 2
    pl = backtransform.plan_of(n, bw, res.HV.shape[1], k, z.element_size(),
                               g, nc)
    assert pl.g == min(g, bw) and pl.nc == (nc or 4)
    ref = bulge.apply_chase_q(res, z)
    bar = 1e-12 if dtype == torch.float64 else 5e-6
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= bar * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("bt", ["auto", "pallas"])
def test_two_stage_solve_on_card_launches_its_kernels(cuda_device,
                                                      monkeypatch, bt):
    from eigenkernel_tpu_torch.solvers import solve

    monkeypatch.setenv("EK_SELECT_CORE", "two_stage")
    monkeypatch.setenv("EK_BACKTRANSFORM", bt)
    rng = np.random.default_rng(3)
    a = rng.standard_normal((300, 300))
    a = (a + a.T) / 2
    for mod in (chase, wf_bt, backtransform):
        mod.LAUNCHES = 0
    pairs = solve(torch.tensor(a, device=cuda_device),
                  solver="scalapack_select", n_vec=12)
    assert chase.LAUNCHES > 0
    assert (backtransform.LAUNCHES if bt == "pallas" else wf_bt.LAUNCHES) > 0
    w = pairs.values.cpu().numpy()
    v = pairs.vectors.cpu().numpy()
    assert np.abs(w - np.linalg.eigvalsh(a)[:12]).max() <= 1e-12 * 30
    assert np.abs(a @ v - v * w[None, :]).max() <= 1e-12 * 30


def _deflate_input(kind, nb, K, dtype, device):
    """One level's scan operands: well separated poles (no deflation),
    rho = 0 (every entry type-1 deflated), runs of 8 equal poles (dense
    type-2 chains) or all poles equal (one chain through every alive
    entry: D1's speculation never holds); tol as _merge_one forms it."""
    rng = np.random.default_rng(K + nb)
    ds = np.sort(rng.standard_normal((nb, K)), axis=1)
    if kind == "none":
        ds = np.arange(K) + rng.uniform(-0.25, 0.25, (nb, K))
    elif kind == "chains":
        ds = np.repeat(ds[:, ::8], 8, axis=1)[:, :K]
    elif kind == "allclose":                 # every alive step close
        ds = np.repeat(ds[:, :1], K, axis=1)
    us = rng.standard_normal((nb, K)) / np.sqrt(K)
    rho = 0.0 if kind == "dead" else 1.0
    tol = 8 * torch.finfo(dtype).eps * np.abs(ds).max(axis=1)
    t = [torch.tensor(x, dtype=dtype, device=device) for x in (ds, us, tol)]
    alive = rho * t[1].abs() > t[2][:, None]
    return t[0], t[1], alive, t[2]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["none", "dead", "chains", "allclose"])
@pytest.mark.parametrize("K", [128, 130, 4096])
@pytest.mark.parametrize("nb", [1, 32])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_deflate_kernel_matches_plain_on_card(cuda_device, dtype, nb, K,
                                              kind):
    ds, us, alive, tol = _deflate_input(kind, nb, K, dtype, cuda_device)
    before = dc.LAUNCHES
    got = dc.deflate_scan(ds, us, alive, tol)
    torch.cuda.synchronize()
    assert dc.LAUNCHES == before + 1
    want = dc.deflate_scan_plain(ds, us, alive, tol)
    for field in dc.Deflation._fields:
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    rot = int(got.rot_m.sum())
    if kind == "chains":
        assert rot > 0 and int(got.depths.max()) >= 6
    elif kind == "allclose":
        assert rot == int(alive.sum()) - nb
        assert int(got.depths.max()) >= K // 2
    else:
        assert rot == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_divide_and_conquer_on_card_one_launch_a_level(cuda_device, dtype):
    n = 300                                  # base 40, 3 levels, padded
    rng = np.random.default_rng(6)
    d_np, e_np = rng.standard_normal(n), rng.standard_normal(n - 1)
    d = torch.tensor(d_np, dtype=dtype, device=cuda_device)
    e = torch.tensor(e_np, dtype=dtype, device=cuda_device)
    before = dc.LAUNCHES
    w, q = dc.tridiag_dc(d, e)
    torch.cuda.synchronize()
    assert dc.LAUNCHES == before + dc._tree_shape(n)[1]
    t = np.diag(d_np) + np.diag(e_np, 1) + np.diag(e_np, -1)
    w, q = w.double().cpu().numpy(), q.double().cpu().numpy()
    scale = np.abs(w).max()
    bar = 5e-13 if dtype == torch.float64 else 5e-5
    assert np.abs(w - np.linalg.eigvalsh(t)).max() <= bar * scale
    assert np.abs(t @ q - q * w[None, :]).max() <= bar * scale
    assert np.abs(q.T @ q - np.eye(n)).max() <= (
        1e-13 if dtype == torch.float64 else 5e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["scalapack", "eigensx", "general_elpa2"])
def test_full_spectrum_solve_on_card_launches_d1(cuda_device, monkeypatch,
                                                 solver):
    from eigenkernel_tpu_torch.solvers import solve

    monkeypatch.delenv("EK_TRIDIAG", raising=False)
    rng = np.random.default_rng(4)
    n = 260
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    m = rng.standard_normal((n, n))
    b = m @ m.T / n + np.eye(n) if solver.startswith("general") else None
    dc.LAUNCHES = 0
    pairs = solve(torch.tensor(a, device=cuda_device),
                  None if b is None else torch.tensor(b, device=cuda_device),
                  solver=solver)
    assert dc.LAUNCHES == dc._tree_shape(n)[1]
    w = pairs.values.cpu().numpy()
    v = pairs.vectors.cpu().numpy()
    bb = np.eye(n) if b is None else b
    w_ref = sla.eigh(a, bb, eigvals_only=True)
    assert np.abs(w - w_ref).max() <= 1e-12 * np.abs(w_ref).max()
    r = np.linalg.norm(a @ v - (bb @ v) * w[None, :], axis=0).max()
    assert r <= 1e-12 * np.linalg.norm(a)
    assert np.abs(v.T @ bb @ v - np.eye(n)).max() <= 1e-12


def _pair_blocks(kind, m, w, dtype, device):
    """m symmetric w x w blocks: random, already diagonal, sparse (a
    diagonal and 16 weak couplings: few sweeps at any w) or degenerate
    (eigenvalues in runs of 8)."""
    rng = np.random.default_rng(w + m)
    if kind == "diagonal":
        a = np.stack([np.diag(rng.standard_normal(w)) for _ in range(m)])
    elif kind == "sparse":
        a = np.stack([np.diag(rng.standard_normal(w)) for _ in range(m)])
        for b in range(m):
            i, j = rng.choice(w, size=(2, 16))
            c = 0.1 * rng.standard_normal(16)
            a[b, i, j] += c
            a[b, j, i] += c
    elif kind == "degenerate":
        q, _ = np.linalg.qr(rng.standard_normal((w, w)))
        lam = np.repeat(rng.standard_normal(-(-w // 8)), 8)[:w]
        a = np.broadcast_to((q * lam) @ q.T, (m, w, w))
    else:
        a = rng.standard_normal((m, w, w))
        a = a + a.transpose(0, 2, 1)
    return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "diagonal", "degenerate"])
@pytest.mark.parametrize("w", [32, 128, 130])
@pytest.mark.parametrize("m", [1, 32, 100])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pair_eigh_kernel_matches_plain_on_card(cuda_device, dtype, m, w,
                                                kind):
    # m = 100: 200 CTAs in clusters of two, more than the card holds at
    # once
    a = _pair_blocks(kind, m, w, dtype, cuda_device)
    before = jacobi.LAUNCHES
    got = jacobi.pair_eigh(a)
    torch.cuda.synchronize()
    assert jacobi.LAUNCHES == before + 1
    want = jacobi.pair_eigh_plain(a)
    for field in jacobi.PairEigh._fields:
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    if kind == "diagonal":
        assert int(got.rotations.sum()) == 0 and (got.sweeps == 1).all()
    else:
        assert (got.rotations > 0).all()
    a64, w64 = a.double().cpu().numpy(), got.values.double().cpu().numpy()
    v = got.vectors.double().cpu().numpy()
    ref = np.linalg.eigvalsh(a64)
    scale = max(1.0, np.abs(ref).max())
    # float32: some 10^4 rotations a block leave ~2e-5 (the phase 4 bar
    # of the smoke, 1e-4, for both)
    bar = 1e-13 if dtype == torch.float64 else 1e-4
    assert np.abs(np.sort(w64, axis=1) - ref).max() <= bar * scale
    assert np.abs(v.transpose(0, 2, 1) @ v - np.eye(w)).max() <= bar


def _pair_smem(w, isz):
    """D2's shared memory by its layout: a set's table ((c, s) and the
    pair packed with its flag, for each of the P pairs, 16-byte aligned);
    a ring of 8 slots, or as many tables as fit; CTA 0 one table, a
    barrier a slot and A (w rows of stride w + 1) where it fits; CTA 1 the
    ring's tables, a barrier a slot and V^T where it fits; both launch
    with the larger."""
    P = (w + 1) // 2
    table = (2 * P * isz + 4 * P + 15) // 16 * 16
    ring = min(8, 232448 // (table + 8))
    cta0, cta1 = table + 8 * ring, ring * (table + 8)
    a_res = cta0 + w * (w + 1) * isz <= 232448
    v_res = cta1 + w * w * isz <= 232448
    cta0 += a_res * w * (w + 1) * isz
    cta1 += v_res * w * w * isz
    return max(cta0, cta1), a_res, v_res


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,w,a_res,v_res", [
    (torch.float64, 128, True, True), (torch.float32, 128, True, True),
    (torch.float64, 168, True, False), (torch.float64, 200, False, False),
    (torch.float32, 33, True, True)])
def test_pair_eigh_placement_on_card(cuda_device, dtype, w, a_res, v_res):
    # A in CTA 0's shared memory and V^T in CTA 1's where each fits (both
    # at the path's w = 128, float64 too), else A in the scratch buffer
    # and V^T in the output: the same bits either way
    isz = torch.empty((), dtype=dtype).element_size()
    smem, got_a, got_v = jacobi.smem_bytes(w, isz)
    assert (got_a, got_v) == (a_res, v_res)
    assert (smem, got_a, got_v) == _pair_smem(w, isz)
    assert smem <= 232448
    a = _pair_blocks("random", 2, w, dtype, cuda_device)
    got = jacobi.pair_eigh(a)
    want = jacobi.pair_eigh_plain(a)
    for field in jacobi.PairEigh._fields:
        assert torch.equal(getattr(got, field), getattr(want, field)), field


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["launch", "width"])
def test_pair_eigh_launch_failure_raises_on_card(cuda_device, monkeypatch,
                                                 fault):
    # a launch the card refuses (here: the launch returning a CUDA error
    # code, or a block wider than the kernel takes) raises; the plain
    # version never stands in on a CUDA tensor
    def no_plain(a):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(jacobi, "pair_eigh_plain", no_plain)
    if fault == "launch":
        lib = build.library()
        monkeypatch.setattr(lib, "ek_pair_jacobi_f64",
                            lambda *args: 912)
        a = _pair_blocks("random", 2, 128, torch.float64, cuda_device)
        with pytest.raises(build.KernelLaunchError, match="912"):
            jacobi.pair_eigh(a)
    else:
        # float64 w = 23,243: one set's table no longer fits the ring's
        # one slot; float32 w = 32,768: past the packed pair's 15 bits
        lib = build.library()
        assert lib.ek_pair_jacobi_f64(0, 1, 23243, 1, 0, 0, 0, 0, 0) != 0
        assert lib.ek_pair_jacobi_f32(0, 1, 32768, 1, 0, 0, 0, 0, 0) != 0
        a = torch.eye(23243, dtype=torch.float64, device=cuda_device)[None]
        with pytest.raises(build.KernelLaunchError):
            jacobi.pair_eigh(a)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,w,ring", [
    (torch.float64, 1100, 8), (torch.float32, 2051, 8),
    (torch.float64, 3001, 7)])
def test_pair_eigh_wide_block_on_card(cuda_device, dtype, w, ring):
    # wider than two pairs a thread (1,100), past 11 bits of a packed
    # pair with a bye (2,051), and a ring of fewer than 8 slots (3,001):
    # the runtime-w kernel, A in the scratch buffer, V^T in the output,
    # bit for bit
    isz = torch.empty((), dtype=dtype).element_size()
    P = (w + 1) // 2
    table = (2 * P * isz + 4 * P + 15) // 16 * 16
    assert min(8, 232448 // (table + 8)) == ring
    smem, a_res, v_res = jacobi.smem_bytes(w, isz)
    assert (smem, a_res, v_res) == _pair_smem(w, isz)
    assert not a_res and not v_res
    a = _pair_blocks("sparse", 1, w, dtype, cuda_device)
    got = jacobi.pair_eigh(a)
    want = jacobi.pair_eigh_plain(a)
    for field in jacobi.PairEigh._fields:
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    assert int(got.rotations.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["jacobi", "general_jacobi", "qdwh_dc",
                                    "mixed"])
def test_extra_cores_and_mixed_on_card(cuda_device, monkeypatch, solver):
    from eigenkernel_tpu_torch.solvers import solve

    monkeypatch.delenv("EK_TRIDIAG", raising=False)
    rng = np.random.default_rng(7)
    n = 300                               # ragged: the Jacobi core pads
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    m = rng.standard_normal((n, n))
    b = m @ m.T / n + np.eye(n) if solver.startswith("general") else None
    jacobi.LAUNCHES = 0
    pairs = solve(torch.tensor(a, device=cuda_device),
                  None if b is None else torch.tensor(b, device=cuda_device),
                  solver="scalapack" if solver == "mixed" else solver,
                  dtype="mixed" if solver == "mixed" else None,
                  block_size=32)
    if solver.endswith("jacobi"):
        # 320 = 10 blocks of 32: 9 rounds a sweep, 12 sweeps
        assert jacobi.LAUNCHES == 9 * 12
    assert pairs.values.dtype == torch.float64
    w = pairs.values.cpu().numpy()
    v = pairs.vectors.cpu().numpy()
    bb = np.eye(n) if b is None else b
    w_ref = sla.eigh(a, bb, eigvals_only=True)
    assert np.abs(w - w_ref).max() <= 1e-12 * np.abs(w_ref).max()
    r = np.linalg.norm(a @ v - (bb @ v) * w[None, :], axis=0).max()
    assert r <= 1e-12 * np.linalg.norm(a)
    assert np.abs(v.T @ bb @ v - np.eye(n)).max() <= 1e-12


@pytest.mark.cuda
def test_two_ranks_on_one_card_select(cuda_device, tmp_path):
    # a 1 x 2 grid of gloo ranks sharing the card: B1 and B2 launched on
    # each; on the selecting core's (d, e) each rank's eigenvalues and
    # first shifted solve equal one device's kernels bit for bit
    from eigenkernel_tpu_torch.ops import tridiag

    n, k = 300, 20
    rng = np.random.default_rng(50)
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    ranks.run_ranks("card_select", 2, (1, 2), a, k, str(tmp_path))
    res = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    d = torch.tensor(res[0]["d"], device=cuda_device)
    e = torch.tensor(res[0]["e"], device=cuda_device)
    calls = []
    solve_fn = tridiag_solve.tridiag_solve

    def record(*args):
        calls.append(args)
        return solve_fn(*args)

    tridiag_solve.tridiag_solve = record
    try:
        lam, _ = tridiag.tridiag_eigh(d, e, k)
    finally:
        tridiag_solve.tridiag_solve = solve_fn
    first = solve_fn(*calls[0]).cpu().numpy()
    for r in res:
        assert (r["launches"] > 0).all()
        j0, j1 = r["lanes"]
        assert np.array_equal(r["d"], res[0]["d"])
        assert np.array_equal(r["first"], first[:, j0:j1])
    w, v = res[0]["w"], res[0]["v"]
    assert np.array_equal(w, lam.cpu().numpy())
    ref = np.linalg.eigvalsh(a)[:k]
    assert np.abs(w - ref).max() <= 1e-10 * np.abs(ref).max()
    assert np.linalg.norm(a @ v - v * w, axis=0).max() <= \
        1e-12 * np.linalg.norm(a)
    assert np.abs(v.T @ v - np.eye(k)).max() <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_banded_chase_entry_on_card_bit_for_bit(cuda_device, dtype):
    # a process grid hands B3 the band as its banded lower storage: the
    # same state as the dense entry builds, so the same bits
    n, bw = 4096, 64
    bnd = _chase_input(n, bw, 70, dtype, cuda_device)
    lower = chase.lower_storage(bnd, bw)
    before = chase.LAUNCHES
    one = chase.band_to_tridiag(bnd, bw)
    two = chase.banded_to_tridiag(lower, n, bw)
    torch.cuda.synchronize()
    assert chase.LAUNCHES == before + 2
    for f in ("d", "e", "HV", "HT"):
        assert torch.equal(getattr(one, f), getattr(two, f))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,bw,chunks,group,cap", [
    (4096, 64, 4, 0, 0),      # window branch, a CTA a lane, the carry
    (4096, 64, 7, 0, 5),      # lane striding on 5 CTAs
    (1000, 64, 300, 4, 0),    # ranges of 4 sweeps, fewer than 5 lanes
    (700, 8, 4, 0, 0),        # b = 8: a short window
    (600, 128, 4, 0, 0),      # the global branch (f64; f32 keeps the window)
    (300, 8, 40, 0, 0)])      # many short ranges
def test_chase_ranges_are_the_whole_chase_on_card(cuda_device, monkeypatch,
                                                  dtype, n, bw, chunks,
                                                  group, cap):
    # B3 over sweep ranges, one launch each, against B3 whole: the same
    # steps in the same order within a sweep, so the same bits
    monkeypatch.setattr(chase, "GRID_CAP", cap)
    bnd = _chase_input(n, bw, 80 + n, dtype, cuda_device)
    lower = chase.lower_storage(bnd, bw)
    whole = chase.banded_to_tridiag(lower, n, bw)
    before = chase.LAUNCHES
    got = chase.band_to_tridiag_chunked(lower, n, bw, chunks, group=group)
    torch.cuda.synchronize()
    ranges = chase.chase_ranges(n, bw, chunks, group)
    assert len(ranges) > 1 and chase.LAUNCHES == before + len(ranges)
    assert chase.BRANCH == chase.branch(bw, dtype)
    last = ranges[-1][1] - ranges[-1][0] + 1
    assert chase.GRID == min(cap or last, last, chase.max_lanes(n, bw))
    for f in ("d", "e", "HV", "HT"):
        assert torch.equal(getattr(got, f), getattr(whole, f)), f
    # the plain version over the same ranges, against the ranges' kernel
    # (at n = 4096 the kernel and the plain whole chase drift apart in d
    # and e past _check_chase's small-n bars, as phase 6 of the smoke
    # records; there the bits against the whole kernel are the check)
    if n <= 1000:
        _check_chase(got, bnd, dtype)
        plain = chase.band_to_tridiag_chunked(lower, n, bw, chunks,
                                              group=group, plain=True)
        lam = _spectrum(got)
        bar = 1e-12 if dtype == torch.float64 else 5e-5
        assert np.abs(_spectrum(plain) - lam).max() <= \
            bar * np.abs(lam).max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kernel", ["wf_bt", "chase_bt"])
def test_back_transform_kernels_on_a_column_share_on_card(cuda_device, dtype,
                                                          kernel):
    # on a grid each rank runs B4 or B5 on its own columns of z: a column
    # slice gives those columns of the whole call
    n, bw, k = 1024, 64, 130
    res, z = _chase_bt_input(n, bw, k, dtype, cuda_device, ())
    fn = wf_bt.apply_chase_q_wavefront if kernel == "wf_bt" \
        else backtransform.apply_chase_q_sweeps
    whole = fn(res, z)
    for lo, hi in ((0, 33), (33, 97), (97, 130), (64, 65)):
        part = fn(res, z[:, lo:hi].contiguous())
        assert torch.equal(part, whole[:, lo:hi])


@pytest.mark.cuda
def test_two_ranks_on_one_card_two_stage(cuda_device, tmp_path):
    # a 1 x 2 grid of gloo ranks sharing the card: general_elpa2 (B3 on
    # each rank, the sharded blocked back-transform) and eigensx under
    # EK_BACKTRANSFORM=wf_pallas (B4) and pallas (B5) on each rank's
    # columns; eigenvalues and the B-metric checks against numpy
    n = 300
    rng = np.random.default_rng(52)
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    m = rng.standard_normal((n, n))
    b = m @ m.T / n + np.eye(n)
    ranks.run_ranks("card_two_stage", 2, (1, 2), a, b, str(tmp_path))
    ref_g = sla.eigh(a, b, eigvals_only=True)
    ref_s = np.linalg.eigvalsh(a)
    for r in range(2):
        res = dict(np.load(tmp_path / f"rank{r}.npz"))
        for tag, ref, kernels in (("elpa2", ref_g, ("chase",)),
                                  ("wf", ref_s, ("chase", "wf_bt")),
                                  ("pallas", ref_s, ("chase", "chase_bt"))):
            launched = dict(zip(("chase", "wf_bt", "chase_bt"),
                                res[f"{tag}/launches"]))
            assert all(launched[k] > 0 for k in kernels)
            assert np.abs(res[f"{tag}/w"] - ref).max() <= \
                1e-10 * np.abs(ref).max()
            resid, orth = res[f"{tag}/check"]
            assert resid <= 1e-12 and orth <= 1e-10


def _panel_bar(m, b, dtype):
    # D3 sums a column's m rows in another order than the plain version
    # (across CTAs, then row groups): about sqrt(m) eps a column on these
    # well-conditioned random panels, carried through b columns
    return b * max(m, 1) ** 0.5 * torch.finfo(dtype).eps


def _panel_quality(p, v, t):
    """||P - QR|| / ||P|| and ||I - Q^T Q||_F of Q = I - V T V^T, in
    float64 (``Q^T Q = I - V S V^T``, S = T + T^T - T^T V^T V T)."""
    p, v, t = p.double(), v.double(), t.double()
    r = torch.triu(p - v @ (t.T @ (v.T @ p)))
    qr = r - v @ (t @ (v.T @ r))
    g = v.T @ v
    s = t + t.T - t.T @ g @ t
    orth = float(torch.trace(s @ g @ s @ g).clamp_min(0)) ** 0.5
    return float((p - qr).norm() / p.norm()), orth


def _check_panel(p, got, want):
    m, b = p.shape
    bar = _panel_bar(m, b, p.dtype)
    for a, ref in ((got[0], want[0]), (got[2], want[2])):
        scale = ref.abs().amax(0).clamp_min(torch.finfo(ref.dtype).tiny)
        assert float(((a - ref).abs().amax(0) / scale).max()) <= bar
    assert float((got[1] - want[1]).abs().max()) <= bar
    resid, orth = _panel_quality(p, got[0], got[2])
    assert resid <= bar and orth <= bar
    jmax = min(m, b)
    assert torch.equal(torch.triu(got[0], 1), torch.zeros_like(got[0]))
    assert bool((got[1][jmax:] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m,b,zero_col", [
    (22436, 64, None), (16320, 64, None), (4032, 64, None), (4032, 64, 5),
    (36, 64, None), (1, 64, None), (300, 8, 0), (129, 16, None),
    (1000, 128, None)])
def test_panel_qr_kernel_matches_plain_on_card(cuda_device, dtype, m, b,
                                               zero_col):
    # D3 against _qr_panel + wy_t_factor on the card: the main path's
    # heights at n = 22,500 and 4096, its ragged last panels, an exactly
    # zero column (tau = 0, head 0, T's diagonal 1), other widths
    rng = np.random.default_rng(m + b)
    pn = rng.standard_normal((m, b))
    if zero_col is not None:
        pn[:, zero_col] = 0.0
    p = torch.tensor(pn, dtype=dtype, device=cuda_device)
    launches = band.LAUNCHES
    got = band.panel_qr(p)
    assert band.LAUNCHES == launches + 1
    _check_panel(p, got, band.panel_qr_plain(p))
    again = band.panel_qr(p)               # a fixed order of sums
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    if zero_col is not None:
        assert float(got[1][zero_col]) == 0.0
        assert float(got[2][zero_col, zero_col]) == 1.0
        assert not bool(got[0][:, zero_col].any())


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [5, 7, 64, 132])
def test_panel_qr_kernel_any_grid_on_card(cuda_device, grid):
    # the cross-CTA sums and barriers at grids panel_plan does not pick,
    # a strided panel (a view of a wider matrix, read in place)
    rng = np.random.default_rng(grid)
    a = torch.tensor(rng.standard_normal((2000, 200)), device=cuda_device)
    p = a[37:, 100:164]
    m = p.shape[0]
    got = band._launch(p, grid, -(-m // grid))
    _check_panel(p, got, band.panel_qr_plain(p))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,b,isz", [(170, 64, 8), (1, 64, 8),
                                        (126, 64, 4), (300, 8, 8),
                                        (217, 128, 8)])
def test_panel_smem_matches_the_source_on_card(cuda_device, rows, b, isz):
    assert build.library().ek_panel_qr_smem(rows, b, isz) == \
        band.panel_smem_bytes(rows, b, isz)


@pytest.mark.cuda
def test_panel_qr_too_large_for_shared_memory_raises_on_card(cuda_device,
                                                             monkeypatch):
    # a panel whose rows do not fit 132 CTAs' shared memory raises; the
    # plain version never stands in on a CUDA tensor
    monkeypatch.setattr(band, "panel_qr_plain", None)
    p = torch.zeros((132 * 500, 64), dtype=torch.float64,
                    device=cuda_device)
    with pytest.raises(build.KernelLaunchError):
        band.panel_qr(p)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 4096])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_to_band_on_card_launches_d3_a_panel(cuda_device, monkeypatch, n,
                                             dtype):
    # one D3 launch a panel, and the band and V of the same reduction with
    # the plain panel within the panels' bars added up (each panel starts
    # from the last one's rounding)
    bw = 64
    rng = np.random.default_rng(n)
    a = rng.standard_normal((n, n))
    a = torch.tensor((a + a.T) / 2, dtype=dtype, device=cuda_device)
    band.LAUNCHES = 0
    got = band.to_band(a, bw)
    assert band.LAUNCHES == len(range(0, n - bw, bw))
    monkeypatch.setattr(band, "panel_qr", band.panel_qr_plain)
    want = band.to_band(a, bw)
    bar = len(range(0, n - bw, bw)) * _panel_bar(n, bw, dtype)
    assert float((got.band - want.band).abs().max()) <= \
        bar * float(a.abs().max())
    assert float((got.V - want.V).abs().max()) <= bar
    assert float((got.taus - want.taus).abs().max()) <= bar
