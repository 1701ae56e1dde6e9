"""Batched Sturm-count bisection for tridiagonal eigenvalues.

Counterpart of ``eigenkernel_tpu/ops/pallas_sturm.py::sturm_bisect``.  The
CUDA kernel (``csrc/sturm_bisect.cu``) runs one thread per target index;
:func:`sturm_bisect_plain` runs the same dstebz recurrence in PyTorch over
a (k,) vector of targets and is what a CPU tensor gets.

    q_i = (d_i - x) - e_{i-1}^2 / q_{i-1},   |q_i| floored at pivmin,
    count(x) = #{i : q_i < 0} = #{eigenvalues < x}
"""

from __future__ import annotations

import torch

from eigenkernel_tpu_torch.ops import build

LAUNCHES = 0  # kernel launches by sturm_bisect (CPU tensors do not count)

_FN = {torch.float64: "ek_sturm_bisect_f64",
       torch.float32: "ek_sturm_bisect_f32"}


def _e2(d: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """(n,) vector ``[0, e_0^2, ..., e_{n-2}^2]``."""
    return torch.cat([torch.zeros(1, dtype=d.dtype, device=d.device), e * e])


def sturm_bisect_plain(d: torch.Tensor, e: torch.Tensor,
                       indices: torch.Tensor, lo0: torch.Tensor,
                       hi0: torch.Tensor, iters: int) -> torch.Tensor:
    """The kernel's recurrence in PyTorch: eigenvalues ``lambda_indices``."""
    n, dtype = d.shape[0], d.dtype
    e2 = _e2(d, e)
    pivmin = 4.0 * torch.finfo(dtype).tiny
    target = indices.to(torch.int64) + 1
    k = indices.shape[0]
    lo = lo0.to(dtype).expand(k).clone()
    hi = hi0.to(dtype).expand(k).clone()
    floor = torch.full((k,), pivmin, dtype=dtype, device=d.device)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        dm = d[:, None] - mid[None, :]            # (n, k): d_i - x
        q = torch.ones_like(mid)
        cnt = torch.zeros(k, dtype=torch.int64, device=d.device)
        for i in range(n):
            q = dm[i] - e2[i] / q
            neg = q < 0
            q = torch.where(q.abs() < pivmin,
                            torch.where(neg, -floor, floor), q)
            cnt += q < 0
        above = cnt >= target                     # lambda_target < mid
        hi = torch.where(above, mid, hi)
        lo = torch.where(above, lo, mid)
    return 0.5 * (lo + hi)


def _check(d, e, indices, lo0, hi0, iters):
    if d.dtype not in _FN:
        raise TypeError(f"sturm_bisect: dtype {d.dtype} not float32/float64")
    if d.dim() != 1 or e.dim() != 1 or indices.dim() != 1:
        raise ValueError("sturm_bisect: d, e and indices must be 1-D")
    n = d.shape[0]
    if n < 1 or e.shape[0] != n - 1:
        raise ValueError(f"sturm_bisect: e has {e.shape[0]} entries, "
                         f"expected n-1 = {n - 1}")
    if e.dtype != d.dtype or lo0.dtype != d.dtype or hi0.dtype != d.dtype:
        raise TypeError("sturm_bisect: d, e, lo0 and hi0 must share a dtype")
    if indices.dtype != torch.int32:
        raise TypeError(f"sturm_bisect: indices must be int32, "
                        f"got {indices.dtype}")
    if lo0.numel() != 1 or hi0.numel() != 1:
        raise ValueError("sturm_bisect: lo0 and hi0 must be scalars")
    for t in (e, indices, lo0, hi0):
        if t.device != d.device:
            raise ValueError("sturm_bisect: all operands on one device")
    if iters < 1:
        raise ValueError(f"sturm_bisect: iters must be >= 1, got {iters}")


def sturm_bisect(d: torch.Tensor, e: torch.Tensor, indices: torch.Tensor,
                 lo0: torch.Tensor, hi0: torch.Tensor,
                 iters: int) -> torch.Tensor:
    """Eigenvalues ``lambda_indices`` (0-based, ascending) of tridiag(d, e)
    by ``iters`` bisection steps on [lo0, hi0].

    d (n,), e (n-1,) float32/float64; indices (k,) int32; lo0, hi0 0-d
    tensors of d's dtype.  A CUDA tensor runs the CUDA kernel, a CPU tensor
    the plain version.
    """
    global LAUNCHES
    _check(d, e, indices, lo0, hi0, iters)
    if d.device.type == "cpu":
        return sturm_bisect_plain(d, e, indices, lo0, hi0, iters)
    if d.device.type != "cuda":
        raise ValueError(f"sturm_bisect: unsupported device {d.device}")
    k = indices.shape[0]
    out = torch.empty(k, dtype=d.dtype, device=d.device)
    if k == 0:
        return out
    d = d.contiguous()
    e2 = _e2(d, e).contiguous()
    idx = indices.contiguous()
    bounds = torch.stack([lo0.reshape(()), hi0.reshape(())]).contiguous()
    lib = build.library()
    name = _FN[d.dtype]
    stream = torch.cuda.current_stream(d.device).cuda_stream
    status = getattr(lib, name)(
        d.data_ptr(), e2.data_ptr(), idx.data_ptr(), bounds.data_ptr(),
        out.data_ptr(), d.shape[0], k, iters, stream)
    build.check(status, name)
    LAUNCHES += 1
    return out
