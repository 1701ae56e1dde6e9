"""Stage-2 back-transform ``z <- Q2 z`` one sweep at a time (kernel B5).

Counterpart of ``eigenkernel_tpu/ops/pallas_backtransform.py::
apply_chase_q_pallas``, the two-stage core's back-transform under
``EK_BACKTRANSFORM=pallas``.  Each sweep's T reflectors act on disjoint row
windows, and the sweeps apply newest first.  A CUDA tensor runs
``csrc/chase_bt.cu`` (one CTA per column tile walking every sweep); a CPU
tensor runs the plain version, :func:`.bulge.apply_chase_q` (one batched
rank-1 update per sweep).
"""

from __future__ import annotations

import torch

from eigenkernel_tpu_torch.ops import build
from eigenkernel_tpu_torch.ops.bulge import ChaseResult, apply_chase_q

LAUNCHES = 0  # kernel launches by apply_chase_q_sweeps

_FN = {torch.float64: "ek_chase_bt_f64", torch.float32: "ek_chase_bt_f32"}


def apply_chase_q_sweeps(res: ChaseResult, z: torch.Tensor) -> torch.Tensor:
    """``Q2 z`` with Q2 the chase transform of ``res``.  Returns a new
    tensor."""
    global LAUNCHES
    hv, ht = res.HV, res.HT
    if z.dtype not in _FN or hv.dtype != z.dtype or ht.dtype != z.dtype:
        raise TypeError(f"apply_chase_q_sweeps: z {z.dtype} and the "
                        f"reflectors {hv.dtype} must be one of "
                        f"float32/float64")
    if z.dim() != 2 or hv.dim() != 3 or ht.shape != hv.shape[:2]:
        raise ValueError(f"apply_chase_q_sweeps: shapes z{tuple(z.shape)} "
                         f"HV{tuple(hv.shape)} HT{tuple(ht.shape)}")
    if z.device != hv.device or z.device != ht.device:
        raise ValueError("apply_chase_q_sweeps: all operands on one device")
    if z.device.type == "cpu":
        return apply_chase_q(res, z)
    if z.device.type != "cuda":
        raise ValueError(f"apply_chase_q_sweeps: unsupported device "
                         f"{z.device}")
    n, k = z.shape
    T, b = hv.shape[1], hv.shape[2]
    out = z.clone(memory_format=torch.contiguous_format)
    if n <= 2 or b <= 1 or hv.shape[0] < n or k == 0:
        return out
    hv, ht = hv.contiguous(), ht.contiguous()
    lib = build.library()
    name = _FN[z.dtype]
    stream = torch.cuda.current_stream(z.device).cuda_stream
    status = getattr(lib, name)(hv.data_ptr(), ht.data_ptr(), out.data_ptr(),
                                n, k, T, b, stream)
    build.check(status, name)
    LAUNCHES += 1
    return out
