"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device (the kernels have no CPU mode) and
skips without one.  The file imports neither jax nor the JAX package, so
it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from eigenkernel_tpu_torch.ops import sturm, tridiag_solve
from eigenkernel_tpu_torch.ops.tridiag import gershgorin_bounds, pivot_floor


def _rand_tridiag(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n), rng.standard_normal(n - 1)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,iters", [(torch.float64, 62),
                                         (torch.float32, 30)])
def test_sturm_kernel_matches_plain_on_card(cuda_device, dtype, iters):
    d_np, e_np = _rand_tridiag(700, 5)
    d = torch.tensor(d_np, dtype=dtype, device=cuda_device)
    e = torch.tensor(e_np, dtype=dtype, device=cuda_device)
    lo, hi = gershgorin_bounds(d, e)
    idx = torch.arange(0, 700, 3, dtype=torch.int32, device=cuda_device)
    before = sturm.LAUNCHES
    lam = sturm.sturm_bisect(d, e, idx, lo, hi, iters)
    torch.cuda.synchronize()
    assert sturm.LAUNCHES == before + 1
    plain = sturm.sturm_bisect_plain(d, e, idx, lo, hi, iters)
    span = float(hi - lo)
    eps = torch.finfo(dtype).eps
    assert float((lam - plain).abs().max()) <= \
        2.0 ** -iters * span + 8 * eps * span


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_solve_kernel_matches_plain_on_card(cuda_device, dtype):
    rng = np.random.default_rng(2)
    n, k = 513, 130
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
