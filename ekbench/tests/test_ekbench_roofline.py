"""The frozen bounds equal the port's own (``obs/flops.py``) today."""

import pytest
import torch

from ekbench import roofline
from eigenkernel_tpu_torch.obs import flops

SHAPES = [(4096, 64), (16384, 64), (22500, 64), (1000, 32), (513, 17)]


@pytest.mark.parametrize("n,b", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_chase_bound_is_the_ports(n, b, dtype):
    assert roofline.bound_chase(n, b, dtype.itemsize) == \
        flops.bound_chase(n, b, dtype)


@pytest.mark.parametrize("n,b", SHAPES)
@pytest.mark.parametrize("k", [500, None])
def test_wf_bt_bound_is_the_ports(n, b, k, monkeypatch):
    monkeypatch.delenv("EK_BT_GROUP", raising=False)
    k = n if k is None else k
    for dtype in (torch.float64, torch.float32):
        assert roofline.bound_wf_bt(n, k, b, dtype.itemsize) == \
            flops.bound_wf_bt(n, k, b, 64, dtype)


def test_peaks_are_the_ports():
    assert (roofline.PEAK_FP64_TENSOR, roofline.PEAK_FP64,
            roofline.PEAK_FP32, roofline.MEM_RATE) == \
        (flops.PEAK_FP64_TENSOR, flops.PEAK_FP64, flops.PEAK_FP32,
         flops.MEM_RATE)
