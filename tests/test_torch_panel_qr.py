"""The panel QR of the full-to-band reduction (``band.panel_qr``, kernel D3's
wrapper) on the CPU.

A CPU tensor runs the plain version, ``_qr_panel`` followed by
``wy_t_factor``, and must return its bits.  D3 itself runs only on a card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``); here a numpy
transcription of its steps (the CTAs' row slices, the partial sums a
column publishes, the pivot rows, the Gram columns folded into the same
sums, T by back substitution) is held to the plain version, so that the
kernel's arithmetic is checked where no card is.  The transcription sums
in another order than the plain version, so the two agree to rounding:
1e-12 of a column's scale in float64 (the panels are well conditioned
and m is at most a few hundred, so a few hundred ulps).
"""

import numpy as np
import pytest
import torch

from eigenkernel_tpu_torch.ops import band, build
from eigenkernel_tpu_torch.ops.householder import wy_t_factor


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _panel(m, b, seed, zero_col=None, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((m, b))
    if zero_col is not None:
        p[:, zero_col] = 0.0
    return torch.tensor(p, dtype=dtype)


# (m, b, zero column): the main path's width at a tall, a square and the
# ragged last panels (m < b, m = 1), a narrow width, and exactly zero
# columns (tau = 0, head 0, an identity in T)
_SHAPES = [(300, 64, None), (64, 64, None), (36, 64, None), (1, 64, None),
           (2, 8, None), (97, 8, None), (130, 16, 3), (40, 8, 0),
           (40, 8, 7)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m,b,zero_col", _SHAPES)
def test_panel_qr_on_cpu_is_the_plain_panel(m, b, zero_col, dtype):
    p = _panel(m, b, m + b, zero_col, dtype)
    before = p.clone()
    launches = band.LAUNCHES
    v2, taus, t = band.panel_qr(p)
    ref_v, ref_taus = band._qr_panel(p.clone())
    ref_t = wy_t_factor(ref_v, ref_taus)
    assert torch.equal(v2, ref_v)
    assert torch.equal(taus, ref_taus)
    assert torch.equal(t, ref_t)
    assert torch.equal(p, before)              # the panel is not modified
    assert band.LAUNCHES == launches           # the CPU launches nothing
    jmax = min(m, b)
    assert torch.equal(torch.triu(v2, 1), torch.zeros_like(v2))
    assert bool((taus[jmax:] == 0).all())
    if zero_col is not None:                   # the identity reflector
        assert float(taus[zero_col]) == 0.0
        assert bool((v2[:, zero_col] == 0).all())
        assert float(t[zero_col, zero_col]) == 1.0


def test_to_band_on_cpu_launches_nothing():
    a = _panel(50, 50, 3)
    a = (a + a.T) / 2
    launches = band.LAUNCHES
    res = band.to_band(a, 8)
    assert band.LAUNCHES == launches
    q = band.apply_band_q(res, torch.eye(50, dtype=a.dtype))
    assert float((q.T @ a @ q - res.band).abs().max()) <= 1e-12 * 50


def _d3_model(p: np.ndarray, grid: int, rows: int):
    """D3's steps (``csrc/panel_qr.cu``) in numpy: CTA c holds rows
    [c rows, (c + 1) rows); step j (-1 .. min(m, b) - 1) reads the sums
    the step before published, applies H_j to its rows and publishes the
    next column's sums, its pivot row and the Gram column j."""
    m, b = p.shape
    W, jmax = b + 1, min(m, b)
    sl = [p[c * rows:min(m, (c + 1) * rows)].copy() for c in range(grid)]
    part = np.zeros((2, grid, W))
    pivot = np.zeros((2, b))
    taus = np.zeros(b)
    gram = np.zeros((b, b))               # V^T V's strict upper part
    for j in range(-1, jmax):
        nx = j + 1
        tau, head, denom, w = 0.0, 0.0, 1.0, np.zeros(b)
        if j >= 0:
            s = part[j & 1].sum(0)
            sigma, alpha = s[0], pivot[j & 1][j]
            zero = sigma == 0
            sgn = 1.0 if alpha >= 0 else -1.0
            beta = alpha if zero else -sgn * np.sqrt(alpha * alpha + sigma)
            denom = 1.0 if zero else alpha - beta
            tau = 0.0 if zero else (beta - alpha) / (1.0 if beta == 0
                                                     else beta)
            head = 0.0 if zero else 1.0
            w = head * pivot[j & 1] + s[1:] / denom
            gram[:max(j - 1, 0), j - 1] = s[1:max(j - 1, 0) + 1]
            taus[j] = tau
        for c, x in enumerate(sl):
            i = c * rows + np.arange(x.shape[0])
            out = np.zeros(W)
            if j >= 0:                     # phase A: column j becomes v
                at = i >= j
                x[at, j] = np.where(i[at] == j, head, x[at, j] / denom)
            if nx < jmax:
                at = i >= nx
                if j >= 0:
                    x[at, nx] -= tau * (x[at, j] * w[nx])
                below = i > nx
                out[0] = (x[below, nx] ** 2).sum()
                if (i == nx).any():
                    pivot[nx & 1][nx] = x[i == nx, nx][0]
            for k in range(b):             # phase B
                if nx < jmax and k > nx:
                    at = i >= nx
                    if j >= 0:
                        x[at, k] -= tau * (x[at, j] * w[k])
                    if (i == nx).any():
                        pivot[nx & 1][k] = x[i == nx, k][0]
                    out[1 + k] = (x[i > nx, nx] * x[i > nx, k]).sum()
                elif k < j:
                    at = i >= j
                    out[1 + k] = (x[at, k] * x[at, j]).sum()
            part[nx & 1][c] = out
    last = part[jmax & 1].sum(0)
    gram[:max(jmax - 1, 0), jmax - 1] = last[1:max(jmax - 1, 0) + 1]
    v = np.concatenate(sl)
    i, k = np.indices(v.shape)
    v = np.where((k < jmax) & (i >= k), v, 0.0)
    # T = inv(M), M = diag(1/tau) + striu(V^T V), by dtrsm's order
    dg = 1.0 / np.where(taus == 0, 1.0, taus)
    x = np.eye(b)
    for i in range(b - 1, -1, -1):
        x[i, i:] /= dg[i]
        x[:i, i:] -= gram[:i, i:i + 1] * x[i:i + 1, i:]
    return v, taus, np.triu(x)


@pytest.mark.parametrize("m,b,zero_col", _SHAPES + [(1000, 64, 5)])
@pytest.mark.parametrize("grid", [1, 3, 8])
def test_kernel_model_matches_the_plain_panel(m, b, zero_col, grid):
    p = _panel(m, b, 2 * m + b, zero_col)
    rows = -(-m // grid)
    v, taus, t = _d3_model(p.numpy(), grid, rows)
    ref_v, ref_taus, ref_t = band.panel_qr_plain(p)
    scale = np.maximum(np.abs(ref_v.numpy()).max(0), 1.0)
    assert np.abs(v - ref_v.numpy()).max(0).max() <= 1e-12 * scale.max()
    assert np.abs(taus - ref_taus.numpy()).max() <= 1e-12
    assert np.abs(t - ref_t.numpy()).max() <= 1e-12 * max(
        1.0, float(ref_t.abs().max()))
    if zero_col is not None and zero_col < min(m, b):
        assert taus[zero_col] == 0.0 and t[zero_col, zero_col] == 1.0
        assert not v[:, zero_col].any()


@pytest.mark.parametrize("m,grid,rows", [(22436, 132, 170),
                                         (16320, 128, 128),
                                         (4032, 32, 126), (36, 1, 36),
                                         (1, 1, 1), (129, 2, 65)])
def test_panel_plan_takes_its_grid_from_m(m, grid, rows):
    g, r = band.panel_plan(m, sms=132)
    assert (g, r) == (grid, rows)
    assert (g - 1) * r < m <= g * r          # no CTA without a row
    assert band.panel_smem_bytes(r, 64, 8) <= band.SMEM_BYTES


def test_panel_plan_fits_every_panel_of_a_card_sized_solve():
    # every panel of an n = 56,000 float64 reduction at bw = 64 (and of
    # n = 28,000 at bw = 128) fits a CTA's shared memory on 132 SMs
    for n, bw in ((56000, 64), (28000, 128)):
        for s in range(0, n - bw, bw):
            rows = band.panel_plan(n - s - bw)[1]
            assert band.panel_smem_bytes(rows, bw, 8) <= band.SMEM_BYTES


def test_panel_qr_refuses_what_the_kernel_does_not_take():
    p = _panel(20, 4, 1)
    with pytest.raises(TypeError):
        band.panel_qr(p.half())
    with pytest.raises(ValueError):
        band.panel_qr(p[:0])
    with pytest.raises(ValueError):
        band.panel_qr(p[0])
    with pytest.raises(ValueError):            # neither the CPU nor CUDA
        band.panel_qr(p.to("meta"))
    assert "ek_panel_qr_f64" in build._SIGNATURES["panel_qr.cu"]
