"""The band -> tridiagonal bulge chase on the stagger-4 wavefront (kernel B3).

Counterpart of ``eigenkernel_tpu/ops/pallas_chase.py::band_to_tridiag_pallas``
(the JAX package's TPU default, which runs the schedule of
``bulge.band_to_tridiag_wavefront2`` as one VMEM-resident kernel).  The
reflectors are those of the JAX package's sequential chase
(``bulge._band_to_tridiag_seq``); only the order of window-disjoint steps
differs.

Schedule: sweeps start 4 chase steps apart.  At step tau, lane j chases
sweep ``c = tau//4 - j`` at band position ``t = tau%4 + 4j``; its window
starts at row ``p = c + 1 + t*b``, so the lanes of one step sit ``4b-1``
rows apart and touch the disjoint row spans ``[p, p+2b)`` (stagger 3 would
collide by one row: the fill ``(p+2b-1, p+b-1)`` is the next window's
pivot).  ``4(n-3) + T`` steps cover every (sweep, position), T = n//b + 2.

State: the lower half of the band with the bulge margin, ``lb[i, q] =
A[i, i+q-2b]``, q in [0, 2b], n + 2b rows (rows >= n are zero).  One lane's
two-sided update, in dense terms (window D = A[p:p+b, p:p+b]):

* pivot column ``x = A[p:p+b, jcol]``, jcol = c for t == 0, else p - b;
  ``(v, tau)`` its Householder with v[0] = 1;
* ``D <- H D H`` (lower half stored, the corner ``A[p+b-1, p+b-1]``
  included), left strip ``A[p:p+b, p-b-1:p] <- H L``, bulge fill rows
  ``A[p+b:p+2b, p:p+b] <- F H``.

A CUDA tensor runs ``csrc/band_chase.cu``: a range of sweeps [c_lo, c_hi]
(the whole chase: [0, n-3]) in one cooperative launch of :func:`grid_size`
CTAs, which stride over the live lanes of each step (:func:`lane_slots`)
with a grid-wide barrier between steps; ``LAUNCHES`` counts one per
launch.  Lane j of a range chases sweep ``c = c_lo + tau//4 - j``.
:func:`banded_to_tridiag_range` chases a range on the state in place,
:func:`band_to_tridiag_chunked` (``EK_CHASE_CHUNKS``, the JAX package's
``bulge.band_to_tridiag_chunked``) the ranges of :func:`chase_ranges` one
after another, each finished range handed to a callback: within a sweep
order nothing changes, so its d, e and reflectors are the whole chase's
bits.  Its branch (:func:`branch`)
stages each lane's window in shared memory ("window", while
:func:`window_words` fits in a block's 227 KB: b <= 84 in float64, b <= 119
in float32) or works on the state in L2 ("global"); with a CTA per lane
the window branch keeps a lane's rows in shared memory from one step to
the next (the source note says how).  A refused launch raises.  A CPU
tensor runs :func:`chase_plain`, the same steps in PyTorch, batched over
the live lanes.  ``EK_CHASE`` (the JAX package's schedule choice) is not
ported: this is the only chase.
"""

from __future__ import annotations

import ctypes

import torch

from eigenkernel_tpu_torch.ops import build
from eigenkernel_tpu_torch.ops.bulge import (ChaseResult, _group_size,
                                             _house_pivot0, _to_banded,
                                             n_chase_groups, trivial_chase)

LAUNCHES = 0  # kernel launches (one per chase; CPU runs add none)
BRANCH = ""   # the branch of the last kernel launch: "window" or "global"
GRID = 0      # CTAs of the last kernel launch
GRID_CAP = 0  # if > 0, at most this many CTAs (tests force lane striding)

SMEM_BYTES = 232448   # shared memory a block may use on sm_90
_THREADS = 512        # csrc/band_chase.cu kThreads

_FN = {torch.float64: "ek_band_chase_f64",
       torch.float32: "ek_band_chase_f32"}
_RESIDENT = {torch.float64: "ek_band_chase_resident_f64",
             torch.float32: "ek_band_chase_resident_f32"}


def n_positions(n: int, b: int) -> int:
    """T, the band positions per sweep of the reflector store."""
    return n // b + 2


def n_steps(n: int, b: int, sweeps: int = 0) -> int:
    """The wavefront steps of a chase of ``sweeps`` sweeps (0: all n - 2),
    ``4(sweeps - 1) + T``."""
    return 4 * ((sweeps or n - 2) - 1) + n_positions(n, b)


def window_words(b: int) -> int:
    """Shared-memory words of the kernel's window branch: rows [p, p+2b)
    at a pitch of 2b + 2, and the scratch v, dv, cl, cr, one word per warp
    and two scalars (``band_chase.cu::window_words``)."""
    return 2 * b * (2 * b + 2) + 4 * b + 1 + _THREADS // 32 + 2


def branch(b: int, dtype: torch.dtype) -> str:
    """"window" where a lane's window fits in a block's shared memory,
    else "global"."""
    return ("window" if window_words(b) * dtype.itemsize <= SMEM_BYTES
            else "global")


def max_lanes(n: int, b: int) -> int:
    """The most lanes a step can hold: t = tau%4 + 4j <= T - 1."""
    return (n_positions(n, b) + 3) // 4


def grid_size(n: int, b: int, resident: int, cap: int = 0,
              sweeps: int = 0) -> int:
    """CTAs of the persistent launch of a range of ``sweeps`` sweeps (0:
    all): no more than the lanes of a step (at most the range's sweeps),
    nor than can be co-resident (``resident``), nor than ``cap`` if
    set."""
    grid = min(max_lanes(n, b), sweeps or n - 2, resident)
    if cap > 0:
        grid = min(grid, cap)
    return max(1, grid)


def lane_slots(j0: int, j1: int, block: int, grid: int) -> list:
    """The lanes j in [j0, j1] that CTA ``block`` of ``grid`` runs: those
    with j = block (mod grid), so that a grid of at least
    :func:`max_lanes` CTAs keeps every lane on one CTA from step to step
    (and its window rows in shared memory)."""
    return [j for j in range(block, j1 + 1, grid) if j >= j0]


def _live_lanes(tau: int, n: int, b: int, T: int, c_lo: int = 0,
                c_hi: int = -1):
    """(c, t, p) of every live lane at step tau of the range [c_lo, c_hi]
    (c_hi < 0: n - 3)."""
    c_hi = n - 3 if c_hi < 0 else c_hi
    out = []
    for j in range(max(0, tau // 4 - (c_hi - c_lo)), tau // 4 + 1):
        t = tau % 4 + 4 * j
        c = c_lo + tau // 4 - j
        p = c + 1 + t * b
        jcol = c if t == 0 else p - b
        if t > T - 1:
            break
        if c <= n - 3 and p < n - 1 and jcol < n - 1:
            out.append((c, t, p))
    return out


def _offsets(b: int, dev):
    """Flat offsets (from row p of the state) of one lane's faces."""
    W = 2 * b + 1
    r = torch.arange(b, device=dev)[:, None]
    s = torch.arange(b, device=dev)[None, :]
    hi, lo = torch.maximum(r, s), torch.minimum(r, s)
    sl = torch.arange(b + 1, device=dev)[None, :]
    return {
        # pivot column for t == 0 (jcol = p-1) and for t > 0 (jcol = p-b)
        "x0": r[:, 0] * W + (2 * b - 1 - r[:, 0]),
        "x1": r[:, 0] * W + (b - r[:, 0]),
        # D[r, s] = A[p+max, p+min]; the write takes its lower half (as
        # indices: a mask would make the device sync, which a CUDA graph
        # cannot capture)
        "D": hi * W + 2 * b + lo - hi,
        "lower": (s <= r).reshape(-1).nonzero()[:, 0],
        # left strip L[r, s] = A[p+r, p-b-1+s], s in [0, b]
        "L": r * W + b - 1 + sl - r,
        # fill rows F[r, s] = A[p+b+r, p+s]
        "F": (b + r) * W + b + s - r,
    }


def chase_plain(lb: torch.Tensor, hv: torch.Tensor, ht: torch.Tensor,
                n: int, b: int, c_lo: int = 0) -> None:
    """The kernel's steps in PyTorch for the sweeps ``c_lo ..
    c_lo + len(hv) - 1``: per step, gather the live lanes' faces, update,
    scatter back.  Updates ``lb``, ``hv`` and ``ht`` (row c - c_lo: sweep
    c) in place.  Every step's lanes go to the device in one copy up
    front; on a CUDA tensor each step replays a CUDA graph of its
    operations, captured once for each count of live lanes, on a static
    copy of the step's lanes (a launch a step, not ~40)."""
    T = hv.shape[1]
    c_hi = c_lo + hv.shape[0] - 1
    dev = lb.device
    off = _offsets(b, dev)
    d_low = off["D"].reshape(-1)[off["lower"]]
    steps = [lanes for lanes in (_live_lanes(tau, n, b, T, c_lo, c_hi)
                                 for tau in range(n_steps(n, b,
                                                          c_hi - c_lo + 1)))
             if lanes]
    every = torch.tensor([(c - c_lo, t, p) for lanes in steps
                          for c, t, p in lanes], device=dev).T  # (3, total)
    # the graphs write nothing to their pool that outlives a replay, so
    # one pool serves them all
    graphs, pool = {}, None
    at = 0
    for lanes in steps:
        idx = every[:, at:at + len(lanes)]
        at += len(lanes)
        if not lb.is_cuda:
            _chase_step(lb, hv, ht, idx, off, d_low, b)
            continue
        if len(lanes) not in graphs:
            static = torch.empty_like(idx)
            graph = torch.cuda.CUDAGraph()
            pool = pool or torch.cuda.graph_pool_handle()
            with torch.cuda.graph(graph, pool=pool):
                _chase_step(lb, hv, ht, static, off, d_low, b)
            graphs[len(lanes)] = (graph, static)
        graph, static = graphs[len(lanes)]
        static.copy_(idx)
        graph.replay()


def _chase_step(lb, hv, ht, idx, off, d_low, b: int) -> None:
    """One step of the plain chase on the lanes ``idx`` = (c, t, p), c the
    row of ``hv`` and ``ht``."""
    W = 2 * b + 1
    flat = lb.view(-1)
    c, t, p = idx
    nl = idx.shape[1]
    base = (p * W)[:, None]
    x = torch.where((t == 0)[:, None], flat[base + off["x0"]],
                    flat[base + off["x1"]])                    # (nl, b)
    v, th = _house_pivot0(x)
    hv[c, t] = v
    ht[c, t] = th
    thv = th[:, None, None]
    base3 = base[:, :, None]
    D = flat[base3 + off["D"]]                                 # (nl,b,b)
    L = flat[base3 + off["L"]]                                 # (nl,b,b+1)
    F = flat[base3 + off["F"]]                                 # (nl,b,b)
    dv = (D * v[:, None, :]).sum(2)
    vdv = (v * dv).sum(1)[:, None, None]
    vv = v[:, :, None] * v[:, None, :]
    dnew = (D - thv * (v[:, :, None] * dv[:, None, :])
            - thv * (dv[:, :, None] * v[:, None, :])
            + thv * thv * vdv * vv)
    cl = (v[:, :, None] * L).sum(1)                            # (nl,b+1)
    L = L - thv * (v[:, :, None] * cl[:, None, :])
    cr = (F * v[:, None, :]).sum(2)                            # (nl, b)
    F = F - thv * (cr[:, :, None] * v[:, None, :])
    flat[base + d_low] = dnew.reshape(nl, -1)[:, off["lower"]]
    flat[base3 + off["L"]] = L
    flat[base3 + off["F"]] = F


def _check(band: torch.Tensor) -> None:
    if band.dtype not in _FN:
        raise TypeError(f"band_to_tridiag: dtype {band.dtype} not "
                        f"float32/float64")
    if band.dim() != 2 or band.shape[0] != band.shape[1]:
        raise ValueError(f"band_to_tridiag: square matrix expected, got "
                         f"{tuple(band.shape)}")


def lower_storage(band: torch.Tensor, b: int) -> torch.Tensor:
    """The chase state ``lb`` (n + 2b, 2b + 1) of a dense band matrix."""
    n = band.shape[0]
    lb = band.new_zeros((n + 2 * b, 2 * b + 1))
    lb[:n] = _to_banded(band, b)
    return lb


def _check_lower(lb: torch.Tensor, n: int, bw: int) -> None:
    if lb.dtype not in _FN:
        raise TypeError(f"banded_to_tridiag: dtype {lb.dtype} not "
                        f"float32/float64")
    if tuple(lb.shape) != (n + 2 * bw, 2 * bw + 1):
        raise ValueError(f"banded_to_tridiag: storage of shape "
                         f"{tuple(lb.shape)}, expected "
                         f"{(n + 2 * bw, 2 * bw + 1)}")


def _result(lb, hv, ht, n: int, b: int) -> ChaseResult:
    return ChaseResult(d=lb[:n, 2 * b].clone(), e=lb[1:n, 2 * b - 1].clone(),
                       HV=hv, HT=ht, bw=b)


def _trivial_lower(lb: torch.Tensor, n: int, bw: int) -> ChaseResult:
    """The chase of n <= 2 or bw <= 1 from the storage (as
    :func:`trivial_chase`)."""
    e = lb[1:n, 2 * bw - 1].clone() if bw >= 1 else \
        lb.new_zeros(max(n - 1, 0))
    return ChaseResult(lb[:n, 2 * bw].clone(), e,
                       lb.new_zeros((n, 1, max(bw, 1))), lb.new_zeros((n, 1)),
                       bw)


def band_to_tridiag_plain(band: torch.Tensor, bw: int,
                          chunks: int = 1) -> ChaseResult:
    """:func:`band_to_tridiag` by the plain version, on any device."""
    _check(band)
    n = band.shape[0]
    if n <= 2 or bw <= 1:
        return trivial_chase(band, bw)
    return band_to_tridiag_chunked(lower_storage(band, bw), n, bw, chunks,
                                   plain=True)


def band_to_tridiag(band: torch.Tensor, bw: int,
                    chunks: int = 1) -> ChaseResult:
    """Reduce a symmetric band matrix (semibandwidth ``bw``, dense storage)
    to tridiagonal, in ``chunks`` sweep ranges (:func:`chase_ranges`).  A
    CUDA tensor runs the CUDA kernel, a CPU tensor the plain version."""
    _check(band)
    n = band.shape[0]
    if band.device.type not in ("cpu", "cuda"):
        raise ValueError(f"band_to_tridiag: unsupported device {band.device}")
    if n <= 2 or bw <= 1:
        return trivial_chase(band, bw)
    return band_to_tridiag_chunked(lower_storage(band, bw), n, bw, chunks)


def banded_to_tridiag(lb: torch.Tensor, n: int, bw: int) -> ChaseResult:
    """:func:`band_to_tridiag` of the band held as its banded lower storage
    ``lb`` (n + 2bw, 2bw + 1), ``lb[i, q] = band[i, i + q - 2bw]`` (zero
    rows past n), the entry a process grid's chase takes
    (``band.banded_lower``): the same state, so the same steps bit for
    bit.  ``lb`` is not modified."""
    return band_to_tridiag_chunked(lb, n, bw, 1)


def chase_ranges(n: int, bw: int, chunks: int, group: int = 0) -> list:
    """The sweep ranges [(c_lo, c_hi), ...] of a chase in ``chunks``
    launches, oldest first: cut at the edges of the WY groups of
    ``bulge.apply_chase_q_blocked`` (g = ``bulge._group_size(group, bw)``
    sweeps, counted back from the last sweep n - 3), ceil(groups /
    chunks) groups a range, the first range the short one; so a finished
    range holds whole groups.  One range for chunks <= 1."""
    last = n - 3
    if chunks <= 1:
        return [(0, last)]
    g = _group_size(group, bw)
    nG = n_chase_groups(n, g)
    per = -(-nG // chunks)
    out = []
    for G0 in range(0, nG, per):
        G1 = min(nG, G0 + per) - 1
        out.append((max(0, last - (G1 + 1) * g + 1), last - G0 * g))
    return out[::-1]


def banded_to_tridiag_range(lb: torch.Tensor, n: int, bw: int, c_lo: int,
                            c_hi: int, out=None, plain: bool = False):
    """Chase the sweeps ``c_lo .. c_hi`` (0 <= c_lo <= c_hi <= n - 3) on
    the banded lower storage ``lb``, updated in place: sweep c's
    reflectors go to row c - c_lo of ``out`` = (hv, ht), zeroed
    (c_hi - c_lo + 1, T, bw) and (c_hi - c_lo + 1, T) tensors (made here
    if None), which it returns.  ``lb`` must hold the state the sweeps
    before c_lo left (the band for c_lo = 0).  A CUDA tensor launches the
    kernel once, a CPU tensor (or ``plain``) runs :func:`chase_plain`."""
    global LAUNCHES, BRANCH, GRID
    _check_lower(lb, n, bw)
    if not 0 <= c_lo <= c_hi <= n - 3:
        raise ValueError(f"banded_to_tridiag_range: sweeps [{c_lo}, "
                         f"{c_hi}] outside [0, {n - 3}]")
    T = n_positions(n, bw)
    if out is None:
        out = (lb.new_zeros((c_hi - c_lo + 1, T, bw)),
               lb.new_zeros((c_hi - c_lo + 1, T)))
    hv, ht = out
    if plain or lb.device.type == "cpu":
        chase_plain(lb, hv, ht, n, bw, c_lo)
        return hv, ht
    if lb.device.type != "cuda":
        raise ValueError(f"banded_to_tridiag: unsupported device "
                         f"{lb.device}")
    lib = build.library()
    name = _FN[lb.dtype]
    br = branch(bw, lb.dtype)
    resident = ctypes.c_int(0)
    build.check(getattr(lib, _RESIDENT[lb.dtype])(
        bw, int(br == "window"), ctypes.byref(resident)), name)
    if resident.value < 1:
        raise build.KernelLaunchError(f"{name}: no block of the {br} branch "
                                      f"fits on {lb.device}")
    grid = grid_size(n, bw, resident.value, GRID_CAP, c_hi - c_lo + 1)
    bar = torch.zeros(1, dtype=torch.int32, device=lb.device)
    stream = torch.cuda.current_stream(lb.device).cuda_stream
    status = getattr(lib, name)(lb.data_ptr(), hv.data_ptr(), ht.data_ptr(),
                                bar.data_ptr(), n, bw, T, c_lo, c_hi,
                                int(br == "window"), grid, stream)
    build.check(status, name)
    LAUNCHES += 1
    BRANCH, GRID = br, grid
    return hv, ht


def band_to_tridiag_chunked(lb: torch.Tensor, n: int, bw: int, chunks: int,
                            keep=None, group: int = 0,
                            plain: bool = False) -> ChaseResult:
    """The chase of the banded lower storage ``lb`` (not modified) in the
    sweep ranges of :func:`chase_ranges` (``chunks``, ``group``), one
    launch each, oldest first (the JAX package's
    ``bulge.band_to_tridiag_chunked``).  Without ``keep`` the ranges
    write into one (n, T, bw) store, returned whole, the bits of the
    whole chase; with it each finished range's (hv, ht) goes to
    ``keep(c_lo, hv, ht)`` and is then dropped, and the result's HV and HT
    are None: a rank of a process grid keeps its own WY groups, and holds
    one range in flight, never the whole store.  ``plain`` runs the plain
    version on any device."""
    _check_lower(lb, n, bw)
    if lb.device.type not in ("cpu", "cuda"):
        raise ValueError(f"banded_to_tridiag: unsupported device "
                         f"{lb.device}")
    if n <= 2 or bw <= 1:
        res = _trivial_lower(lb, n, bw)
        if keep is not None:
            keep(0, res.HV, res.HT)
            res = res._replace(HV=None, HT=None)
        return res
    lb = lb.contiguous().clone()
    T = n_positions(n, bw)
    if keep is None:
        hv, ht = lb.new_zeros((n, T, bw)), lb.new_zeros((n, T))
    for c_lo, c_hi in chase_ranges(n, bw, chunks, group):
        if keep is None:
            banded_to_tridiag_range(lb, n, bw, c_lo, c_hi,
                                    (hv[c_lo:c_hi + 1], ht[c_lo:c_hi + 1]),
                                    plain)
        else:
            keep(c_lo, *banded_to_tridiag_range(lb, n, bw, c_lo, c_hi,
                                                plain=plain))
    if keep is not None:
        hv = ht = None
    return _result(lb, hv, ht, n, bw)
