"""The dlatrd panel of the one-stage tridiagonalization
(``householder.tridiag_panel``, kernel D4's wrapper), on the CPU and on a
card.

A CPU tensor runs the plain version, ``tridiag_panel_plain``, and must
return its bits.  D4 itself runs only on a card (the ``cuda`` tests below,
``chip_smoke.py --d4``); on the CPU a numpy transcription of its steps
(the CTAs' row ranges and tile ranges, the lower triangle's tiles walked
column by column, a slot a tile and a slot a run, the reflector formed by
every CTA, w's last axpy folded into the next column) is held to the plain
version, on a block whose upper triangle is NaN, so that the kernel's
arithmetic and its reading of the lower triangle alone are checked where
no card is.  The transcription sums in another order than the plain
version, so the two agree to rounding: 1e-12 of the block's scale in
float64.

This file imports neither jax nor the JAX package, so the card tests also
run where only PyTorch is installed:

    python -m pytest tests/test_torch_panel_trd.py -m cuda --noconftest
"""

import math

import numpy as np
import pytest
import torch

from eigenkernel_tpu_torch.ops import build, householder as hh


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _sym(n, seed, zero_cols=0):
    """A random symmetric (n, n) matrix; its first ``zero_cols`` columns
    (and rows) vanish below the subdiagonal, so that their reflectors are
    the identity."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    for j in range(min(zero_cols, n)):
        a[j + 2:, j] = 0.0
        a[j, j + 2:] = 0.0
    return a


def _outputs(m, bw, dtype, device="cpu"):
    z = dict(dtype=dtype, device=device)
    return (torch.zeros(bw, **z), torch.zeros(min(bw, m - 1), **z),
            torch.zeros(bw, **z))


def _panel(a, bw, fn=hh.tridiag_panel):
    d, e, taus = _outputs(a.shape[0], bw, a.dtype, a.device)
    vw, wv = fn(a, bw, d, e, taus)
    return vw, wv, d, e, taus


# (m, bw, zero columns): the main path's width on tall, square and ragged
# last panels (bw = m), one and two rows, a narrow and an odd width, and
# columns that vanish below the subdiagonal (tau = 0, head 0)
_SHAPES = [(300, 64, 0), (64, 64, 0), (65, 64, 0), (37, 37, 0), (1, 1, 0),
           (2, 2, 0), (3, 3, 0), (130, 8, 0), (200, 37, 0), (150, 64, 3),
           (40, 8, 8)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m,bw,zero_cols", _SHAPES)
def test_tridiag_panel_on_cpu_is_the_plain_panel(m, bw, zero_cols, dtype):
    a = torch.tensor(_sym(m, m + bw, zero_cols), dtype=dtype)
    before = a.clone()
    launches = hh.LAUNCHES
    got = _panel(a, bw)
    want = _panel(a.clone(), bw, hh.tridiag_panel_plain)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert torch.equal(a, before)              # the block is not modified
    assert hh.LAUNCHES == launches             # the CPU launches nothing
    vw, wv = got[:2]
    assert torch.equal(wv, torch.cat([vw[:, bw:], vw[:, :bw]], dim=1))
    v = vw[:, :bw]
    assert torch.equal(torch.triu(v), torch.zeros_like(v))
    for j in range(min(zero_cols, m - 1)):     # the identity reflector
        assert float(got[4][j]) == 0.0 and not bool(v[:, j].any())


def test_tridiagonalize_takes_a_transposed_layout_row_major(monkeypatch):
    # a generalized reduction hands over its matrix transposed (strides
    # (1, n)); every panel's block still reaches the panel with unit
    # column stride, so that D4 reads it in place
    n = 100
    a = torch.tensor(_sym(n, 9)).T.contiguous().T
    assert a.stride() == (1, n)
    strides = []
    panel = hh.tridiag_panel

    def recording(As, *args):
        strides.append(As.stride())
        return panel(As, *args)

    monkeypatch.setattr(hh, "tridiag_panel", recording)
    tri = hh.tridiagonalize(a, block=32)
    assert strides == [(n, 1)] * 4
    ref = hh.tridiagonalize(a.contiguous(), block=32)
    assert torch.equal(tri.d, ref.d) and torch.equal(tri.e, ref.e)


def test_tridiagonalize_on_cpu_matches_the_panels():
    # the whole reduction on the CPU: T = Q^T A Q with the panels' d, e
    n = 150
    a = torch.tensor(_sym(n, 5))
    launches = hh.LAUNCHES
    tri = hh.tridiagonalize(a, block=64)
    assert hh.LAUNCHES == launches
    q = hh.apply_q(tri, torch.eye(n, dtype=a.dtype))
    t = hh.tridiag_matrix(tri.d, tri.e)
    assert float((q.T @ a @ q - t).abs().max()) <= 1e-12 * n
    # the first panel's d, e, taus and V are the plain panel's
    vw, _, d, e, taus = _panel(a.clone(), 64, hh.tridiag_panel_plain)
    assert torch.equal(tri.d[:64], d) and torch.equal(tri.e[:64], e)
    assert torch.equal(tri.taus[:64], taus)
    assert torch.equal(tri.V[:, :64], vw[:, :64])


def _first_unit(nu, ratio, u):
    """D4's decode of unit number u: the strip S whose units hold it (the
    root of the quadratic, then corrected), and the row unit U."""
    start = lambda s: s * nu - ratio * s * (s - 1) // 2  # noqa: E731
    ns = -(-nu // ratio)
    b = nu + 0.5 * ratio
    s = math.floor((b - math.sqrt(b * b - 2.0 * ratio * u)) / ratio)
    s = max(0, min(s, ns - 1))
    while s + 1 < ns and start(s + 1) <= u:
        s += 1
    while s > 0 and start(s) > u:
        s -= 1
    return s, ratio * s + (u - start(s))


def _d4_model(a, bw, grid, itemsize=8):
    """D4's steps (``csrc/panel_trd.cu``) in numpy on the (m, m) block
    ``a``, of which only the lower triangle may be read, with the walk of
    a kernel of ``itemsize``: CTA c owns rows [c rows, (c + 1) rows) and
    units [c per, (c + 1) per) of the lower triangle.  Scratch and outputs
    start as NaN, and each column's slots are set to NaN before it, so that
    a slot read before it is written shows."""
    m = a.shape[0]
    H, W = hh.UNIT_ROWS, hh.STRIP_BYTES // itemsize
    R = W // H
    rows = -(-m // grid)
    nu = -(-m // H)
    ns, units = hh.trd_units(m, itemsize)
    start = lambda s: s * nu - R * s * (s - 1) // 2  # noqa: E731
    assert start(ns) == units
    per = -(-units // grid)
    own = [(min(m, c * rows), min(m, c * rows + rows)) for c in range(grid)]
    vt = np.full((3 * bw, m), np.nan)
    Vt, Wt, Vd = vt[:bw], vt[bw:2 * bw], vt[2 * bw:]
    d, e, taus = _outputs(m, bw, torch.float64)
    d, e, taus = d.numpy(), e.numpy(), taus.numpy()
    colbuf, wprime, ybuf = (np.full(m, np.nan) for _ in range(3))
    part_sig, part_dot = np.full(grid, np.nan), np.full(grid, np.nan)
    part_vw = np.full((grid, 2 * bw), np.nan)
    tau_prev = 0.0
    for j in range(bw + 1):
        # phase 1: the fold of w, column j from the pending update phase 3
        # left (A's own column for j = 0) less column j - 1's term
        coef = vj = wj = 0.0
        if j > 0:
            coef = 0.5 * tau_prev * part_dot.sum()
            vj = Vt[j - 1, j]
            wj = wprime[j] - coef * vj
        for c, (r0, r1) in enumerate(own):
            i = np.arange(max(j, r0), r1)
            if j == 0:
                col = a[i, 0]
            else:
                v = Vt[j - 1, i]
                w = wprime[i] - coef * v
                Wt[j - 1, i] = w
                if j == bw:
                    continue
                col = colbuf[i] - (v * wj + w * vj)
            colbuf[i] = col
            if (i == j).any():
                d[j] = col[i == j][0]
            part_sig[c] = (col[i >= j + 2] ** 2).sum()
        if j == bw:
            break
        if j == m - 1:
            for r0, r1 in own:
                vt[[j, bw + j, 2 * bw + j], r0:r1] = 0.0
            break
        r = j + 1                            # phase 2: the reflector
        sigma, alpha = part_sig.sum(), colbuf[r]
        zero = sigma == 0
        beta = alpha if zero else -(1.0 if alpha >= 0 else -1.0) * \
            math.sqrt(alpha * alpha + sigma)
        denom = 1.0 if zero else alpha - beta
        tau = 0.0 if zero else (beta - alpha) / (1.0 if beta == 0 else beta)
        head, inv = (0.0 if zero else 1.0), 1.0 / denom
        tau_prev = tau
        vfull = np.zeros(m + W)
        vfull[r] = head
        vfull[r + 1:m] = colbuf[r + 1:m] * inv
        for r0, r1 in own:
            Vt[j, r0:r1] = Vd[j, r0:r1] = vfull[r0:r1]
        rowpart = np.full((units, H), np.nan)
        colpart = np.full((ns + grid, W), np.nan)
        for c in range(grid):               # A v over the lower triangle
            u, u_hi = per * c, min(units, per * c + per)
            if u >= u_hi:
                continue
            s_, U = _first_unit(nu, R, u)
            cacc = np.zeros(W)
            while u < u_hi:
                ro, co = U * H, s_ * W
                x = np.zeros((H, W))
                hr, hc = min(m, ro + H) - ro, min(m, co + W) - co
                x[:hr, :hc] = a[ro:ro + hr, co:co + hc]
                row = ro + np.arange(H)[:, None]
                col = co + np.arange(W)[None, :]
                if (s_ + 1) * W <= U * H:   # wholly below the diagonal
                    xr = xc = x
                else:
                    xr = np.where(col <= row, x, 0.0)
                    xc = np.where(col < row, x, 0.0)
                rowpart[u] = xr @ vfull[co:co + W]
                cacc += xc.T @ vfull[ro:ro + H]
                u += 1
                Un, Sn = U + 1, s_
                if Un == nu:
                    Sn += 1
                    Un = R * Sn
                if u == u_hi or Sn != s_:
                    colpart[s_ + c] = cacc
                    cacc = np.zeros(W)
                U, s_ = Un, Sn
        for c, (r0, r1) in enumerate(own):
            i = np.arange(max(r, r0), r1)
            src = np.concatenate([Vt[:j], Wt[:j]])
            part_vw[c, :2 * j] = src[:, i] @ vfull[i]
        for c, (r0, r1) in enumerate(own):  # phase 3: y, w', w'^T v
            for i in range(max(r, r0), r1):
                ui, hi = i // H, i % H
                y = sum(rowpart[start(s2) + ui - R * s2, hi]
                        for s2 in range(ui // R + 1))
                si = i // W
                c_lo, c_hi = start(si) // per, (start(si + 1) - 1) // per
                y += sum(colpart[si + c2, i % W]
                         for c2 in range(c_lo, c_hi + 1))
                ybuf[i] = y
        tot = part_vw[:, :2 * j].sum(0)
        rowv, roww = (Vt[:j, j + 1].copy(), Wt[:j, j + 1].copy()) \
            if j + 1 < bw else (None, None)
        colbuf[:] = np.nan                  # col j is not read past here
        for c, (r0, r1) in enumerate(own):
            i = np.arange(r0, r1)
            Wt[j, i[i < r]] = 0.0
            i = i[i >= r]
            corr = Vt[:j, i].T @ tot[j:2 * j] + Wt[:j, i].T @ tot[:j]
            wprime[i] = tau * (ybuf[i] - corr)
            part_dot[c] = wprime[i] @ Vt[j, i]
            if j + 1 < bw:                  # the next column's pending update
                colbuf[i] = a[i, j + 1] - (Vt[:j, i].T @ roww
                                           + Wt[:j, i].T @ rowv)
        e[j], taus[j] = beta, tau
    return vt, d, e, taus


@pytest.mark.parametrize("m,bw,zero_cols", _SHAPES + [(1100, 4, 0),
                                                     (2100, 2, 0)])
@pytest.mark.parametrize("grid,itemsize", [(1, 8), (3, 8), (8, 8), (5, 4)])
def test_kernel_model_matches_the_plain_panel(m, bw, zero_cols, grid,
                                              itemsize):
    # the walk of the float64 kernel (strips of 256 columns) at three grids
    # and of the float32 kernel's (512), in float64 arithmetic
    a = _sym(m, 2 * m + bw, zero_cols)
    poisoned = np.where(np.tril(np.ones((m, m), dtype=bool)), a, np.nan)
    vt, d, e, taus = _d4_model(poisoned, bw, grid, itemsize)
    vw, wv, rd, re, rtaus = _panel(torch.tensor(a), bw,
                                   hh.tridiag_panel_plain)
    assert not np.isnan(vt).any()            # every output entry written
    scale = np.abs(a).max() * m
    np.testing.assert_allclose(vt[:2 * bw].T, vw.numpy(), rtol=0,
                               atol=1e-12 * scale)
    np.testing.assert_allclose(vt[bw:].T, wv.numpy(), rtol=0,
                               atol=1e-12 * scale)
    for x, ref in ((d, rd), (e, re), (taus, rtaus)):
        np.testing.assert_allclose(x, ref.numpy(), rtol=0,
                                   atol=1e-12 * scale)
    for j in range(min(zero_cols, m - 1)):
        assert taus[j] == 0.0 and not vt[j].any()


@pytest.mark.parametrize("m,itemsize,grid", [
    (22500, 8, 132), (22436, 4, 132), (4004, 8, 132), (1000, 8, 39),
    (1000, 4, 24), (500, 8, 12), (300, 8, 6), (65, 8, 2), (64, 8, 1),
    (1, 8, 1)])
def test_trd_plan_takes_its_grid_from_m(m, itemsize, grid):
    assert hh.trd_plan(m, itemsize, sms=132) == grid
    # at least UNITS_MIN units a CTA where the SMs allow it
    units = hh.trd_units(m, itemsize)[1]
    assert grid == 132 or units >= hh.UNITS_MIN * (grid - 1)


@pytest.mark.parametrize("m,itemsize,strips,units", [
    (22500, 8, 88, 62568), (22500, 4, 44, 31636), (256, 8, 1, 16),
    (257, 8, 2, 18), (2100, 8, 9, 612), (2100, 4, 5, 340), (1, 8, 1, 1),
    (1, 4, 1, 1)])
def test_trd_units_cover_the_lower_triangle(m, itemsize, strips, units):
    assert hh.trd_units(m, itemsize) == (strips, units)
    # units of UNIT_ROWS rows by a strip's width, strip by strip from the
    # first the diagonal crosses, hold every entry of the lower triangle
    if m < 3000:
        w, h = hh.STRIP_BYTES // itemsize, hh.UNIT_ROWS
        seen = np.zeros((m, m), dtype=bool)
        for s in range(strips):
            for u in range(s * w // h, -(-m // h)):
                seen[u * h:u * h + h, s * w:s * w + w] = True
        assert seen[np.tril_indices(m)].all()


def test_trd_scratch_of_a_card_sized_solve():
    # every panel of the n = 22,500 reduction at bw = 64 on 132 SMs takes
    # at most 64 MB of scratch; the first takes the most
    n, bw = 22500, 64
    for isz in (8, 4):
        sizes = [hh.trd_scratch_words(n - s, min(bw, n - s),
                                      hh.trd_plan(n - s, isz), isz) * isz
                 for s in range(0, n, bw)]
        assert max(sizes) == sizes[0] <= 64 * 2 ** 20
        # a slot of UNIT_ROWS words for each of the triangle's units
        assert sizes[0] > hh.trd_units(n, isz)[1] * hh.UNIT_ROWS * isz


def test_tridiag_panel_refuses_what_the_kernel_does_not_take():
    a = torch.tensor(_sym(20, 1))
    d, e, taus = _outputs(20, 4, a.dtype)
    with pytest.raises(TypeError):
        hh.tridiag_panel(a.half(), 4, d, e, taus)
    with pytest.raises(ValueError):            # not square
        hh.tridiag_panel(a[:, :10], 4, d, e, taus)
    with pytest.raises(ValueError):            # wider than the block
        hh.tridiag_panel(a[:3, :3], 4, d, e, taus)
    with pytest.raises(ValueError):            # neither the CPU nor CUDA
        hh.tridiag_panel(a.to("meta"), 4, d, e, taus)
    assert "ek_panel_trd_f64" in build._SIGNATURES["panel_trd.cu"]


# ---- on a card ------------------------------------------------------------

def _bar(m, bw, dtype):
    # D4 sums A v's m rows and the CTAs' partial sums in another order than
    # the plain version, about sqrt(m) eps a column of ||A||, carried
    # through the panel's bw columns; a late column of a small block has a
    # tail far shorter than ||A||, and its v carries eps ||A|| / ||tail||
    # of either order's rounding (a panel of 63 columns on 63 rows differs
    # by ~700 eps in float32), so the bar grows with m, not sqrt(m)
    return bw * max(m, 1) * torch.finfo(dtype).eps


def _check_panel(a, got, want):
    m = a.shape[0]
    bw = got[4].shape[0]
    norm = max(float(torch.linalg.matrix_norm(a.double(), ord=2)), 1e-300)
    bar = _bar(m, bw, a.dtype)
    vw, wv, d, e, taus = got
    rvw, rwv, rd, re, rtaus = want
    v, w = vw[:, :bw], vw[:, bw:]
    assert float((v - rvw[:, :bw]).abs().max()) <= bar
    assert float((taus - rtaus).abs().max()) <= bar
    assert float((w - rvw[:, bw:]).abs().max()) <= bar * norm
    assert float((d - rd).abs().max()) <= bar * norm
    if m > 1:
        assert float((e - re).abs().max()) <= bar * norm
    assert torch.equal(wv, torch.cat([w, v], dim=1))
    assert torch.equal(torch.triu(v), torch.zeros_like(v))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [1, 2, 63, 64, 65, 200, 1000, 4096])
def test_panel_kernel_matches_plain_on_card(cuda_device, dtype, n):
    # D4 against the plain panel on the first panel of an n x n matrix
    # (bw = min(64, n): n <= 64 is a ragged last panel); two launches on
    # the same block give the same bits
    a = torch.tensor(_sym(n, n), dtype=dtype, device=cuda_device)
    bw = min(64, n)
    launches = hh.LAUNCHES
    got = _panel(a, bw)
    assert hh.LAUNCHES == launches + 1
    _check_panel(a, got, _panel(a, bw, hh.tridiag_panel_plain))
    again = _panel(a, bw)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,bw,zero_cols", [(300, 64, 5), (300, 64, 300),
                                            (200, 37, 0), (130, 8, 2)])
def test_panel_kernel_identity_reflectors_and_widths_on_card(
        cuda_device, dtype, n, bw, zero_cols):
    # columns that vanish below the subdiagonal (tau = 0, v = 0; a
    # diagonal matrix has nothing else), odd and narrow widths
    a = torch.tensor(_sym(n, 7, zero_cols), dtype=dtype, device=cuda_device)
    if zero_cols >= n:
        a = torch.diag(torch.diagonal(a))
    got = _panel(a, bw)
    _check_panel(a, got, _panel(a, bw, hh.tridiag_panel_plain))
    for j in range(min(zero_cols, bw)):
        assert float(got[4][j]) == 0.0
        assert not bool(got[0][:, j].any())


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [1, 5, 64, 132])
def test_panel_kernel_any_grid_on_card(cuda_device, grid):
    # the cross-CTA sums and barriers at grids trd_plan does not pick, on
    # a block read in place at an odd offset (no 16-byte loads)
    a = torch.tensor(_sym(500, grid), device=cuda_device)
    blk = a[5:, 5:]
    d, e, taus = _outputs(495, 64, a.dtype, a.device)
    got = [*hh._launch(blk, 64, d, e, taus, grid), d, e, taus]
    _check_panel(blk, got, _panel(blk, 64, hh.tridiag_panel_plain))


@pytest.mark.cuda
def test_panel_kernel_refuses_a_transposed_block_on_card(cuda_device):
    # D4 reads rows in place; a block without unit column stride raises
    # rather than being copied whole for every panel
    a = torch.tensor(_sym(200, 1), device=cuda_device).T.contiguous().T
    with pytest.raises(ValueError):
        hh.tridiag_panel(a, 64, *_outputs(200, 64, a.dtype, a.device))


@pytest.mark.cuda
@pytest.mark.parametrize("isz", [8, 4])
@pytest.mark.parametrize("m,bw,grid", [(22500, 64, 132), (4000, 64, 132),
                                       (1, 1, 1), (300, 37, 4)])
def test_panel_scratch_matches_the_source_on_card(cuda_device, m, bw, grid,
                                                  isz):
    assert build.library().ek_panel_trd_scratch(m, bw, grid, isz) == \
        hh.trd_scratch_words(m, bw, grid, isz)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [1000, 4096])
def test_tridiagonalize_on_card_launches_d4_a_panel(cuda_device, monkeypatch,
                                                   n, dtype):
    # the whole reduction: one D4 launch a panel, and ||Q^T A Q - T|| and
    # ||Q^T Q - I|| at the plain panel's level on the same matrix
    a = torch.tensor(_sym(n, 3), dtype=dtype, device=cuda_device)
    eye = torch.eye(n, dtype=dtype, device=cuda_device)
    norm = float(torch.linalg.matrix_norm(a.double(), ord=2))

    def quality(tri):
        q = hh.apply_q(tri, eye)
        t = hh.tridiag_matrix(tri.d, tri.e)
        return (float((q.T @ a @ q - t).abs().max()) / norm,
                float((q.T @ q - eye).abs().max()))

    launches = hh.LAUNCHES
    got = quality(hh.tridiagonalize(a, block=64))
    assert hh.LAUNCHES == launches + -(-n // 64)
    monkeypatch.setattr(hh, "tridiag_panel", hh.tridiag_panel_plain)
    plain = quality(hh.tridiagonalize(a, block=64))
    floor = n * torch.finfo(dtype).eps
    for x, ref in zip(got, plain):
        assert x <= max(4 * ref, floor)
