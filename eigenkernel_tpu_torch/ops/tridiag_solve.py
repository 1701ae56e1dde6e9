"""Batched shifted tridiagonal solves ``(T - lam_j I) x_j = b_j``.

Counterpart of ``eigenkernel_tpu/ops/pallas_solve.py::tridiag_solve_pallas``
(the inner step of inverse iteration).  The CUDA kernel
(``csrc/tridiag_solve.cu``) runs one thread per system and one warp of 32
systems per block over row-major (n, k) operands, with the rows it reads
staged in shared memory ``ROWS`` at a time, ahead of the sweep;
:func:`tridiag_solve_plain` runs the same LU recurrences in PyTorch, one
row of k systems at a time, and is what a CPU tensor gets.

    forward:  l = e_{i-1}/u_{i-1};  u_i = (d_i - lam) - e_{i-1} l  (floored)
              y_i = b_i - l y_{i-1}
    backward: x_i = (y_i - e_i x_{i+1}) / u_i
"""

from __future__ import annotations

import torch

from eigenkernel_tpu_torch.ops import build

LAUNCHES = 0  # kernel launches by tridiag_solve (CPU tensors do not count)
ROWS = 64     # rows of a chunk the kernel stages (csrc kRows)

_FN = {torch.float64: "ek_tridiag_solve_f64",
       torch.float32: "ek_tridiag_solve_f32"}


def tridiag_solve_plain(d: torch.Tensor, e: torch.Tensor, lam: torch.Tensor,
                        b: torch.Tensor, tiny: float) -> torch.Tensor:
    """The kernel's recurrences in PyTorch, row by row over (k,) vectors."""
    n, k = b.shape
    floor = torch.full((k,), tiny, dtype=d.dtype, device=d.device)
    dm = d[:, None] - lam[None, :]               # (n, k): d_i - lam_j
    u = torch.empty_like(b)
    y = torch.empty_like(b)
    u_prev = torch.ones(k, dtype=d.dtype, device=d.device)
    y_prev = torch.zeros(k, dtype=d.dtype, device=d.device)
    for i in range(n):
        if i == 0:
            ui, yi = dm[0].clone(), b[0].clone()
        else:
            el = e[i - 1]
            l = el / u_prev
            ui = dm[i] - el * l
            yi = b[i] - l * y_prev
        ui = torch.where(ui.abs() < tiny, torch.where(ui < 0, -floor, floor),
                         ui)
        u[i], y[i] = ui, yi
        u_prev, y_prev = ui, yi
    x = torch.empty_like(b)
    x[n - 1] = y[n - 1] / u[n - 1]
    for i in range(n - 2, -1, -1):
        x[i] = (y[i] - e[i] * x[i + 1]) / u[i]
    return x


def _check(d, e, lam, b):
    if d.dtype not in _FN:
        raise TypeError(f"tridiag_solve: dtype {d.dtype} not float32/float64")
    if d.dim() != 1 or e.dim() != 1 or lam.dim() != 1 or b.dim() != 2:
        raise ValueError("tridiag_solve: d, e, lam 1-D and b 2-D expected")
    n, k = b.shape
    if d.shape[0] != n or n < 1 or e.shape[0] != n - 1 or lam.shape[0] != k:
        raise ValueError(
            f"tridiag_solve: shapes d{tuple(d.shape)} e{tuple(e.shape)} "
            f"lam{tuple(lam.shape)} b{tuple(b.shape)} do not match")
    for t in (e, lam, b):
        if t.dtype != d.dtype:
            raise TypeError("tridiag_solve: d, e, lam and b must share a "
                            "dtype")
        if t.device != d.device:
            raise ValueError("tridiag_solve: all operands on one device")


def tridiag_solve(d: torch.Tensor, e: torch.Tensor, lam: torch.Tensor,
                  b: torch.Tensor, tiny: float) -> torch.Tensor:
    """Solve ``(tridiag(d, e) - lam_j I) x_j = b_j`` for every column j.

    d (n,), e (n-1,), lam (k,), b (n, k), all float32 or all float64.
    ``tiny`` > 0 floors |pivot| (inverse iteration passes
    :func:`eigenkernel_tpu_torch.ops.tridiag.pivot_floor`).  A CUDA tensor
    runs the CUDA kernel, a CPU tensor the plain version.
    """
    global LAUNCHES
    _check(d, e, lam, b)
    tiny = float(tiny)
    if not tiny > 0:
        raise ValueError(f"tridiag_solve: pivot floor must be > 0, got {tiny}")
    if d.device.type == "cpu":
        return tridiag_solve_plain(d, e, lam, b, tiny)
    if d.device.type != "cuda":
        raise ValueError(f"tridiag_solve: unsupported device {d.device}")
    n, k = b.shape
    x = torch.empty_like(b, memory_format=torch.contiguous_format)
    if k == 0:
        return x
    d, e, lam, b = (t.contiguous() for t in (d, e, lam, b))
    u = torch.empty_like(x)
    y = torch.empty_like(x)
    lib = build.library()
    name = _FN[d.dtype]
    stream = torch.cuda.current_stream(d.device).cuda_stream
    status = getattr(lib, name)(
        d.data_ptr(), e.data_ptr(), lam.data_ptr(), b.data_ptr(),
        u.data_ptr(), y.data_ptr(), x.data_ptr(), n, k, tiny, stream)
    build.check(status, name)
    LAUNCHES += 1
    return x
