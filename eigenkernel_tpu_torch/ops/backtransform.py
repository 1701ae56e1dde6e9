"""Stage-2 back-transform ``z <- Q2 z`` from the chase reflectors (kernel B5).

Counterpart of ``eigenkernel_tpu/ops/pallas_backtransform.py::
apply_chase_q_pallas``, the two-stage core's back-transform under
``EK_BACKTRANSFORM=pallas``.  A CPU tensor runs the plain version,
:func:`.bulge.apply_chase_q` (one batched rank-1 update per sweep).  A CUDA
tensor runs ``csrc/chase_bt.cu`` in the block order of
:func:`.bulge.apply_chase_q_blocked`: g consecutive sweeps at one band
position form one compact-WY block ``I - Y T^T Y^T`` over a (b+g-1)-row
window; groups go newest first, positions ascending inside a group.  Two
launches a call: one writes the g x g factor T of every live block, one
CTA per column tile of z walks every block, the window sliding down with
each position.  The kernel sums in another order than the plain version,
so the two agree to rounding, not bit for bit.

Here also live the pure-Python model of the kernel's block schedule
(:func:`group_span`, :func:`block_schedule`) and its geometry
(:func:`plan_of`, :func:`smem_bytes`), whose constants the launcher passes
to the kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eigenkernel_tpu_torch.ops import build
from eigenkernel_tpu_torch.ops.bulge import ChaseResult, apply_chase_q

LAUNCHES = 0  # kernel launches by apply_chase_q_sweeps (2 a call)

GROUP = 64            # sweeps per WY block (clamped to b)
WARPS = 8             # warps per CTA of the apply kernel
SMEM_BYTES = 232448   # shared memory a block can use on sm_90

_FN = {torch.float64: "ek_chase_bt_f64", torch.float32: "ek_chase_bt_f32"}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def group_span(n: int, b: int, T: int, g: int, G: int):
    """``(c0, row0, count)`` of group G: its newest sweep, the first row
    of its window at position 0, and its live positions t < count (the
    windows that start above row n; the rest hold only zero
    reflectors)."""
    c0 = n - 3 - G * g
    row0 = c0 - g + 2
    return c0, row0, min(T, -(-(n - row0) // b))


def block_schedule(n: int, b: int, T: int, g: int):
    """Yield ``(G, t, c0, row0)`` for every block in the kernel's order:
    groups newest first, positions ascending; the block applies sweeps
    c0, c0 - 1, ..., c0 - g + 1 (those >= 0) to rows [row0, row0 + b + g
    - 1)."""
    for G in range(-(-(n - 2) // g)):
        c0, row0, count = group_span(n, b, T, g, G)
        for t in range(count):
            yield G, t, c0, row0 + t * b


def _split(itemsize: int, gp: int, nc: int) -> int:
    """Depth slices of the float64 product ``Y^T z``: enough for its
    16 x 8 tiles (a 4-column tile pads to 8) to occupy every warp."""
    if itemsize != 8:
        return 1
    return max(1, WARPS // ((gp // 16) * max(1, nc // 8)))


def smem_bytes(itemsize: int, b: int, g: int, nc: int) -> int:
    """Shared memory of the apply kernel (``ek_chase_bt_smem``): 128 bytes
    of barriers, two buffers of a block's reflector rows (gp rows of b
    rounded up to 16 bytes, plus 8 words in float64), T^T (gp x gp+4),
    the z ring, the slices of Y^T z and the scaled product (ring, slices x
    gp and gp rows of max(nc, 8) + 4 words)."""
    gp = _round_up(g, 16)
    pv = _round_up(b, 16) + 8 if itemsize == 8 else _round_up(b, 4)
    words = (2 * gp * pv + gp * (gp + 4)
             + (ring_rows(b, g) + (_split(itemsize, gp, nc) + 1) * gp)
             * (max(nc, 8) + 4))
    return 128 + words * itemsize


def ring_rows(b: int, g: int) -> int:
    """Rows of the z ring: a power of two that holds a window (b + g - 1
    rows), the next b rows loaded during it and the b rows before it,
    stored during it."""
    r = 1
    while r < 3 * b + g - 1:
        r *= 2
    return r


class Plan(NamedTuple):
    """One launch: T band positions, g sweeps a block (gp padded to 16),
    nG groups, ``blocks`` live blocks, column tiles of nc, ``ctas`` of
    them."""
    T: int
    g: int
    gp: int
    nG: int
    blocks: int
    nc: int
    ctas: int


def plan_of(n: int, b: int, T: int, k: int, itemsize: int,
            group: int = GROUP, nc: int = 0, sms: int = 132) -> Plan:
    """The :class:`Plan` of ``z <- Q2 z`` for z (n, k).  g = min(group, b,
    64) (g > b would make blocks two positions apart overlap, and the
    kernel is built for g <= 64); nc the narrowest of 4, 8, 16 columns
    whose tiles give at most a CTA to every SM (16 where none does: a
    second CTA on an SM shares its load pipes and gains nothing); then nc
    and g halve until the shared memory fits.  Raises ValueError where
    even g = 1 does not fit (bands of several hundred)."""
    g = max(1, min(group, b, 64))
    if nc <= 0:
        nc = 4
        while nc < 16 and -(-k // nc) > sms:
            nc *= 2
    while smem_bytes(itemsize, b, g, nc) > SMEM_BYTES:
        if nc > 4:
            nc //= 2
        elif g > 1:
            g //= 2
        else:
            raise ValueError(f"apply_chase_q_sweeps: band {b} too wide for "
                             f"the kernel's shared memory")
    nG = -(-(n - 2) // g)
    blocks = sum(group_span(n, b, T, g, G)[2] for G in range(nG))
    return Plan(T, g, _round_up(g, 16), nG, blocks, nc, -(-k // nc))


def apply_chase_q_sweeps(res: ChaseResult, z: torch.Tensor) -> torch.Tensor:
    """``Q2 z`` with Q2 the chase transform of ``res``.  Returns a new
    tensor."""
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
    return _launch(res, z, GROUP)


def _launch(res: ChaseResult, z: torch.Tensor, group: int,
            nc: int = 0) -> torch.Tensor:
    """The kernel at g = min(group, b) (and column tiles of ``nc``, 0 for
    the plan's pick) on CUDA tensors; the tests and the smoke reach each
    g through it."""
    global LAUNCHES
    n, k = z.shape
    T, b = res.HV.shape[1], res.HV.shape[2]
    out = z.clone(memory_format=torch.contiguous_format)
    if n <= 2 or b <= 1 or res.HV.shape[0] < n or k == 0:
        return out
    hv, ht = res.HV.contiguous(), res.HT.contiguous()
    sms = torch.cuda.get_device_properties(z.device).multi_processor_count
    pl = plan_of(n, b, T, k, z.element_size(), group, nc, sms)
    # T^T of every (group, position) block, gp x (gp + 4), written by the
    # first launch and read by the second
    tf = z.new_empty((pl.nG * T * pl.gp * (pl.gp + 4),))
    lib = build.library()
    name = _FN[z.dtype]
    stream = torch.cuda.current_stream(z.device).cuda_stream
    status = getattr(lib, name)(hv.data_ptr(), ht.data_ptr(), tf.data_ptr(),
                                out.data_ptr(), n, k, T, b, pl.g, pl.nc,
                                stream)
    build.check(status, name)
    LAUNCHES += 2
    return out
