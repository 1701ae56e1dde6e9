"""The kernel bounds of ``eigenkernel_tpu_torch/obs/flops.py`` and the pure
helpers of the persistent chase launch, against hand counts (CPU only)."""

import pytest
import torch

from eigenkernel_tpu_torch.obs import flops
from eigenkernel_tpu_torch.ops import chase, wf_bt


@pytest.mark.parametrize("n,b", [(20, 3), (37, 4), (64, 8), (101, 16)])
def test_chase_live_lanes_match_the_schedule(n, b):
    T = chase.n_positions(n, b)
    brute = sum(len(chase._live_lanes(tau, n, b, T))
                for tau in range(chase.n_steps(n, b)))
    assert flops.chase_live_lanes(n, b) == brute


def _brute_wf_bt(pl, u0, u1):
    """(launches, lane-steps) from wf_bt._live_lanes, one step at a time."""
    launches = steps = 0
    for u in range(u0, u1):
        lo, hi = wf_bt._live_lanes(pl, u)
        if lo <= hi:
            launches += 1
            steps += hi - lo + 1
    return launches, steps


@pytest.mark.parametrize("n,b,g", [(40, 3, 5), (130, 3, 7), (300, 8, 0),
                                   (257, 16, 40), (600, 64, 0)])
def test_wf_bt_lane_steps_match_live_lanes(monkeypatch, n, b, g):
    monkeypatch.delenv("EK_BT_GROUP", raising=False)
    pl = wf_bt.plan_of(n, b, chase.n_positions(n, b), 8, g)
    assert flops.wf_bt_lane_steps(pl) == _brute_wf_bt(pl, 0, pl.Tq2)
    mid = pl.Tq2 // 2
    assert flops.wf_bt_lane_steps(pl, 1, mid) == _brute_wf_bt(pl, 1, mid)


def test_wf_bt_bound_at_the_path_shape(monkeypatch):
    # n = 16384, k = 500, b = g = 64 (m = 1, S2 = 128): 512 launches and
    # 33,152 lane-steps of 2 S2^2 k operations on the FP64 tensor cores
    monkeypatch.delenv("EK_BT_GROUP", raising=False)
    ms, by, launches, steps = flops.bound_wf_bt(16384, 500, 64, 64,
                                                torch.float64)
    assert (launches, steps) == (512, 33152)
    assert by == "operations"
    assert ms == pytest.approx(2 * 128 ** 2 * 500 * 33152 / 67e12 * 1e3)
    # float32 has the same peak on the CUDA cores
    assert flops.bound_wf_bt(16384, 500, 64, 64, torch.float32)[0] == \
        pytest.approx(ms)


def test_bounds_by_hand_at_small_shapes():
    # B1: 3 operations a Sturm step, float64 on the CUDA cores
    ms, by = flops.bound_sturm(100, 10, 62, torch.float64)
    assert by == "operations"
    assert ms == pytest.approx(3 * 100 * 62 * 10 / 34e12 * 1e3)
    # B2: one pass over b and x dominates: bytes
    ms, by = flops.bound_solve(1000, 50, torch.float32)
    assert by == "bytes"
    assert ms == pytest.approx((2 * 1000 + 50 + 2 * 1000 * 50) * 4
                               / 3.35e12 * 1e3)
    # B3 at n = 20, b = 3: 18 + 15 + 12 + 9 + 6 + 3 = 63 live lanes
    assert flops.chase_live_lanes(20, 3) == 63
    ms, by = flops.bound_chase(20, 3, torch.float64)
    ops, nbytes = 12 * 9 * 63, (2 * 26 * 7 + 63 * 4) * 8
    assert ms == pytest.approx(max(ops / 34e12, nbytes / 3.35e12) * 1e3)
    # B5: 4 b k operations per live reflector, float64 on the tensor cores
    ms, by = flops.bound_chase_bt(20, 7, 3, torch.float32)
    ops, nbytes = 4 * 3 * 7 * 63, (63 * 4 + 2 * 20 * 7) * 4
    assert ms == pytest.approx(max(ops / 67e12, nbytes / 3.35e12) * 1e3)
    ms, by = flops.bound_chase_bt(4096, 500, 64, torch.float64)
    ops = 4 * 64 * 500 * flops.chase_live_lanes(4096, 64)
    assert by == "operations"
    assert ms == pytest.approx(ops / 67e12 * 1e3)


def test_pair_eigh_bound_by_hand():
    # D2 at w = 4: 3 sets a sweep, 18 w operations a rotation; 5 sweeps
    # of 100 ns sets are the chain
    ms, by = flops.bound_pair_eigh(2, 4, 5, 60, torch.float64, 100.0)
    assert by == "operations"
    assert ms == pytest.approx(max(18 * 4 * 60 / 34e12, 5 * 3 * 100e-9)
                               * 1e3)
    # many rotations, no chain: the operations at the CUDA-core peak
    ms, by = flops.bound_pair_eigh(2, 4, 5, 10 ** 9, torch.float64, 0.0)
    assert ms == pytest.approx(18 * 4 * 1e9 / 34e12 * 1e3)
    # few rotations, no chain: the bytes bound it
    ms, by = flops.bound_pair_eigh(32, 129, 3, 1000, torch.float32, 0.0)
    nbytes = (2 * 32 * 129 * 129 + 32 * 129) * 4 + 8 * 32
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    # odd w: w sets a sweep
    ms, _ = flops.bound_pair_eigh(1, 5, 2, 0, torch.float64, 1e6)
    assert ms == pytest.approx(2 * 5 * 1e6 * 1e-9 * 1e3)


@pytest.mark.parametrize("dtype,limit", [(torch.float64, 84),
                                         (torch.float32, 119)])
def test_chase_branch_flips_at_the_window_limit(dtype, limit):
    isz = torch.empty((), dtype=dtype).element_size()
    assert chase.window_words(limit) * isz <= chase.SMEM_BYTES
    assert chase.window_words(limit + 1) * isz > chase.SMEM_BYTES
    assert chase.branch(limit, dtype) == "window"
    assert chase.branch(limit + 1, dtype) == "global"
    assert chase.branch(2, dtype) == "window"
    assert chase.branch(128, dtype) == "global"


@pytest.mark.parametrize("n,b,resident,cap,grid", [
    (16384, 64, 132, 0, 65),     # the lanes of a step bound the grid
    (16384, 8, 132, 0, 132),     # the co-resident blocks bound it
    (600, 8, 132, 3, 3),         # a cap forces striding
    (10, 8, 132, 0, 1)])
def test_chase_grid_size(n, b, resident, cap, grid):
    assert chase.grid_size(n, b, resident, cap) == grid


@pytest.mark.parametrize("j0,j1,grid", [(0, 19, 3), (5, 64, 65), (2, 2, 4),
                                        (0, 131, 132)])
def test_chase_lane_slots_cover_each_lane_once(j0, j1, grid):
    seen = [j for blk in range(grid) for j in chase.lane_slots(j0, j1, blk,
                                                               grid)]
    assert sorted(seen) == list(range(j0, j1 + 1))


def test_chase_max_lanes_bounds_every_step():
    n, b = 300, 8
    T = chase.n_positions(n, b)
    most = max(len(chase._live_lanes(tau, n, b, T))
               for tau in range(chase.n_steps(n, b)))
    assert most <= chase.max_lanes(n, b)
