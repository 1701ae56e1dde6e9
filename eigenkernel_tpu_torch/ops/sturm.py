"""Batched Sturm-count bisection for tridiagonal eigenvalues.

Counterpart of ``eigenkernel_tpu/ops/pallas_sturm.py::sturm_bisect``.  The
CUDA kernel (``csrc/sturm_bisect.cu``) runs a block of W = 1 or 2 warps
per target index and counts, in one pass over the rows, at every node of
the depth-(5 + log2 W) bisection tree below the target's interval, then walks
the tree: it visits the points that one-step bisection visits and returns
the same bits in ceil(iters / depth) passes.  :func:`sturm_bisect_plain`
runs the same dstebz recurrence in PyTorch one step at a time over a (k,)
vector of targets and is what a CPU tensor gets; :func:`bisection_rounds`
models the kernel's passes in PyTorch.

    q_i = (d_i - x) - e_{i-1}^2 / q_{i-1},   |q_i| floored at pivmin,
    count(x) = #{i : q_i < 0} = #{eigenvalues < x}
"""

from __future__ import annotations

import torch

from eigenkernel_tpu_torch.ops import build

LAUNCHES = 0  # kernel launches by sturm_bisect (CPU tensors do not count)
LEVELS = 5      # tree levels one warp's 32 node slots cover
MAX_WARPS = 2   # warps per target: trees of depth 5 or 6 (csrc kMaxWarps)
WARPS_PER_SM = 8  # the grid's warps an SM at most (2 a scheduler)

_FN = {torch.float64: "ek_sturm_bisect_f64",
       torch.float32: "ek_sturm_bisect_f32"}


def _e2(d: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """(n,) vector ``[0, e_0^2, ..., e_{n-2}^2]``."""
    return torch.cat([torch.zeros(1, dtype=d.dtype, device=d.device), e * e])


GRAPH_ROWS = 128  # rows a CUDA graph of the plain count replays


def _count_rows(dm, e2, q, cnt, floor, neg_floor, pivmin: float):
    """The recurrence over the rows of ``dm`` (rows, m) and ``e2``: returns
    the last q, counts into ``cnt`` in place."""
    for i in range(dm.shape[0]):
        q = dm[i] - e2[i] / q
        neg = q < 0             # the floor keeps the sign: neg is q < 0 after
        q = torch.where(q.abs() < pivmin, torch.where(neg, neg_floor, floor),
                        q)
        cnt += neg
    return q


_GRAPHS: dict = {}


def _count_graph(m: int, dtype, dev, pivmin: float):
    """A CUDA graph of :func:`_count_rows` over GRAPH_ROWS rows of (m,)
    points, on static buffers (dm, e2, q, cnt, floor, neg_floor)."""
    key = (m, dtype, dev, pivmin)
    if key not in _GRAPHS:
        dm = torch.zeros((GRAPH_ROWS, m), dtype=dtype, device=dev)
        e2 = torch.zeros(GRAPH_ROWS, dtype=dtype, device=dev)
        q = torch.ones(m, dtype=dtype, device=dev)
        cnt = torch.zeros(m, dtype=torch.int64, device=dev)
        floor = torch.full((m,), pivmin, dtype=dtype, device=dev)
        neg_floor = -floor
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            q.copy_(_count_rows(dm, e2, q, cnt, floor, neg_floor, pivmin))
        _GRAPHS[key] = (graph, dm, e2, q, cnt, floor, neg_floor)
    return _GRAPHS[key]


def _sturm_count(d: torch.Tensor, e2: torch.Tensor, x: torch.Tensor,
                 pivmin: float) -> torch.Tensor:
    """#{eigenvalues < x} for every entry of ``x`` (any shape), int64.  On
    a CUDA tensor the rows go GRAPH_ROWS at a time through one CUDA graph
    of the same operations (a launch a chunk, not ~7 a row)."""
    shape = x.shape
    x = x.reshape(-1)
    dm = d[:, None] - x[None, :]                  # (n, m): d_i - x
    n, m = dm.shape
    full = n // GRAPH_ROWS * GRAPH_ROWS if x.is_cuda else 0
    if full:
        graph, dm_s, e2_s, q, cnt, floor, neg_floor = _count_graph(
            m, x.dtype, x.device, pivmin)
        q.fill_(1.0)
        cnt.zero_()
        for r0 in range(0, full, GRAPH_ROWS):
            dm_s.copy_(dm[r0:r0 + GRAPH_ROWS])
            e2_s.copy_(e2[r0:r0 + GRAPH_ROWS])
            graph.replay()
        q, cnt = q.clone(), cnt.clone()
    else:
        floor = torch.full_like(x, pivmin)
        neg_floor = -floor
        q = torch.ones_like(x)
        cnt = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    _count_rows(dm[full:], e2[full:], q, cnt, floor, neg_floor, pivmin)
    return cnt.reshape(shape)


def sturm_bisect_plain(d: torch.Tensor, e: torch.Tensor,
                       indices: torch.Tensor, lo0: torch.Tensor,
                       hi0: torch.Tensor, iters: int) -> torch.Tensor:
    """The kernel's recurrence in PyTorch: eigenvalues ``lambda_indices``."""
    dtype = d.dtype
    e2 = _e2(d, e)
    pivmin = 4.0 * torch.finfo(dtype).tiny
    target = indices.to(torch.int64) + 1
    k = indices.shape[0]
    lo = lo0.to(dtype).expand(k).clone()
    hi = hi0.to(dtype).expand(k).clone()
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        above = _sturm_count(d, e2, mid, pivmin) >= target  # lambda < mid
        hi = torch.where(above, mid, hi)
        lo = torch.where(above, lo, mid)
    return 0.5 * (lo + hi)


def warps_per_target(k: int, sms: int) -> int:
    """Warps a target's block gets: the largest power of 2, at most
    ``MAX_WARPS``, that keeps the k blocks within ``WARPS_PER_SM`` warps an
    SM, so that every warp's division chain runs near its latency while the
    deeper tree cuts the passes."""
    w = 1
    while w < MAX_WARPS and 2 * w * k <= WARPS_PER_SM * sms:
        w *= 2
    return w


def depth_of(warps: int) -> int:
    """Tree levels one pass of the kernel covers with ``warps`` warps a
    target: their 32 * warps threads hold the 2^depth - 1 nodes."""
    return LEVELS + warps.bit_length() - 1


def tree_node(j: int) -> tuple:
    """(level, position) of heap index ``j = 2^level - 1 + position``.  The
    children of node j are 2j + 1 (below its point) and 2j + 2 (above);
    the bits of the position, most significant first, are the path from
    the root (1: above)."""
    level = (j + 1).bit_length() - 1
    return level, j + 1 - (1 << level)


def round_depths(iters: int, depth: int) -> list:
    """Levels each pass of the kernel walks: ceil(iters / depth) passes,
    the last one shorter where depth does not divide iters."""
    return [min(depth, iters - s) for s in range(0, iters, depth)]


def node_points(lo: torch.Tensor, hi: torch.Tensor, depth: int):
    """(2^depth - 1, k) points: row j is where the lane holding node j
    counts, reached from [lo, hi] by bisecting along the node's path with
    the arithmetic of one bisection step."""
    pts = []
    for j in range((1 << depth) - 1):
        level, pos = tree_node(j)
        l, h = lo, hi
        for s in range(level - 1, -1, -1):
            m = 0.5 * (l + h)
            if (pos >> s) & 1:
                l = m
            else:
                h = m
        pts.append(0.5 * (l + h))
    return torch.stack(pts)


def bisection_rounds(d: torch.Tensor, e: torch.Tensor, indices: torch.Tensor,
                     lo0: torch.Tensor, hi0: torch.Tensor, iters: int,
                     depth: int = LEVELS) -> list:
    """The kernel's schedule in PyTorch: per pass, count at every node of
    the tree below each target's [lo, hi] and walk it on the rule count >=
    idx + 1 => hi = mid.  Returns [(lo, hi)] after each pass; at depth 1
    that is one-step bisection."""
    e2 = _e2(d, e)
    pivmin = 4.0 * torch.finfo(d.dtype).tiny
    target = indices.to(torch.int64) + 1
    k = indices.shape[0]
    lo = lo0.to(d.dtype).expand(k).clone()
    hi = hi0.to(d.dtype).expand(k).clone()
    out = []
    for walk in round_depths(iters, depth):
        cnt = _sturm_count(d, e2, node_points(lo, hi, walk), pivmin)
        j = torch.zeros(k, dtype=torch.int64, device=d.device)
        for _ in range(walk):
            mid = 0.5 * (lo + hi)
            above = cnt.gather(0, j[None])[0] >= target
            hi = torch.where(above, mid, hi)
            lo = torch.where(above, lo, mid)
            j = torch.where(above, 2 * j + 1, 2 * j + 2)
        out.append((lo, hi))
    return out


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
    by ``iters`` bisection steps on [lo0, hi0] (the kernel takes them
    ``depth_of(warps)`` levels a pass, to the same bits).

    d (n,), e (n-1,) float32/float64; indices (k,) int32; lo0, hi0 0-d
    tensors of d's dtype.  A CUDA tensor runs the CUDA kernel, a CPU tensor
    the plain version.
    """
    _check(d, e, indices, lo0, hi0, iters)
    if d.device.type == "cpu":
        return sturm_bisect_plain(d, e, indices, lo0, hi0, iters)
    if d.device.type != "cuda":
        raise ValueError(f"sturm_bisect: unsupported device {d.device}")
    sms = torch.cuda.get_device_properties(d.device).multi_processor_count
    return _launch(d, e, indices, lo0, hi0, iters,
                   warps_per_target(indices.shape[0], sms))


def _launch(d, e, indices, lo0, hi0, iters, warps):
    """The kernel at ``warps`` warps a target on checked CUDA operands."""
    global LAUNCHES
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
        out.data_ptr(), d.shape[0], k, iters, warps, stream)
    build.check(status, name)
    LAUNCHES += 1
    return out
