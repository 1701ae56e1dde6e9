"""Stage-2 back-transform ``z <- Q2 z`` on the composite group wavefront
(kernel B4).

Counterpart of ``eigenkernel_tpu/ops/pallas_wf_bt.py::
apply_chase_q_wavefront_pallas``, the two-stage core's default
back-transform.  The schedule, as there:

* g consecutive sweeps form a group; at band position t their reflectors
  live in a (b+g-1)-row window and compose to one WY factor
  ``P = I - Y M^{-1} Y^T`` (``bulge._wy_embed``,
  ``M = diag(1/tau) + tril(Y^T Y, -1)``);
* m consecutive band positions of a group compose further into one
  explicit (S2 x S2) transform, ``S2 = g + m*b``;
* at composite step u, group G applies its composite ``i = u - G``; the
  windows of one step sit S2 rows apart (disjoint), and every overlapping
  pair keeps its order of the sequential product (the proof is in the JAX
  module), so the result is exactly Q2 z.

:func:`_q_stream` builds the transforms in PyTorch (batched triangular
solves and GEMMs, outside the kernel as in JAX), in phases of composite
steps under a byte budget: at n = 16384, g = 64 the whole stream is
(Tm + nG - 1) nG S2^2 words, 17 GB in float64.  Per phase, a CUDA tensor
runs ``csrc/wf_bt.cu`` (:func:`apply_phase`: one launch per composite
step; for S2 <= 128 one CTA per live lane and column split, which keeps
the lane's P in shared memory and walks its tiles of z, else one CTA per
live lane and column tile with P streamed (``BRANCH`` says which ran);
float64 on the FP64 tensor cores (DMMA), float32 in register tiles on the
CUDA cores); a CPU tensor runs :func:`apply_phase_plain`, one
``torch.bmm`` over the live lanes per step.  The kernel sums in another
order than cuBLAS, so the two agree to rounding, not bit for bit.  Its
bound at n = 16384, k = 500, b = g = 64 is 8.1 ms of arithmetic
(``obs/flops.py::bound_wf_bt``: 512 launches, 33,152 lane-steps of
2 S2^2 k operations at 67 TFLOP/s).

``EK_BT_GROUP`` sets g (default 64); m follows the JAX package's rule,
the largest m with S2 <= 128 (at least 1, at most T), so a narrow band
composes deeper.  Both were picked on a TPU.  The Mosaic envelope (8 | b, 8 | g, b + g <= 128, S2 <= 256) and the
fallback to the XLA wavefront do not exist here: any b >= 2, g, m >= 1 run.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import torch

from eigenkernel_tpu_torch.obs import events
from eigenkernel_tpu_torch.ops import build
from eigenkernel_tpu_torch.ops.bulge import (ChaseResult, _wy_embed,
                                             group_stores)

LAUNCHES = 0  # kernel launches (one per composite step with live lanes)
BRANCH = ""   # the kernel's branch at the last launch: "resident"/"streamed"
STREAM_BYTES = 2 * 2 ** 30   # byte budget of one phase of the P stream

_FN = {torch.float64: "ek_wf_bt_f64", torch.float32: "ek_wf_bt_f32"}


def _composite_views(X: torch.Tensor, Xt: torch.Tensor, m: int, U: int):
    """Composite-anti-diagonal views of the group-major stores:
    ``hvu[u, j, G] = X[G, m*(u-G)+j]`` (shape (U, m, nG, g*b)), zero where
    the band position falls in the t-padding, and garbage (a neighbouring
    group's data) where ``u < G`` or ``u - G >= U``: those (u, G) are dead
    lanes, which the kernel never reads.  A reshape and a permuted view, no
    gather."""
    nG, T, blk = X.shape
    gg = Xt.shape[2]
    Tp = m * (U + 1)
    Xp = torch.cat([X, X.new_zeros((nG, Tp - T, blk))], dim=1)
    Xtp = torch.cat([Xt, Xt.new_zeros((nG, Tp - T, gg))], dim=1)
    # flat row m*(G*U + u) + j  ==  X[G, m*(u-G)+j]
    hv = Xp.view(nG * (U + 1), m, blk)[: nG * U]
    ht = Xtp.view(nG * (U + 1), m, gg)[: nG * U]
    hvu = hv.view(nG, U, m, blk).permute(1, 2, 0, 3)
    htu = ht.view(nG, U, m, gg).permute(1, 2, 0, 3)
    return hvu, htu


def _p_minus_i(hv: torch.Tensor, ht: torch.Tensor, g: int, b: int,
               S: int) -> torch.Tensor:
    """``I - P = Y M^{-1} Y^T`` of B windows: hv (B, g*b), ht (B, g)."""
    Y = _wy_embed(hv.reshape(-1, g, b), g, b, S)            # (B, S, g)
    gram = Y.transpose(1, 2) @ Y
    tau_safe = torch.where(ht == 0, 1.0, ht)
    M = torch.tril(gram, -1) + torch.diag_embed(1.0 / tau_safe)
    eye = torch.eye(g, dtype=hv.dtype, device=hv.device).expand_as(M)
    minv = torch.linalg.solve_triangular(M, eye, upper=False)
    return (Y @ minv) @ Y.transpose(1, 2)


def _q_stream(hvu: torch.Tensor, htu: torch.Tensor, g: int, b: int, m: int,
              tchunk: int = 8) -> torch.Tensor:
    """The (tc, nG, S2, S2) composite window transforms of the composite
    steps in ``hvu`` ((tc, m, nG, g*b)) / ``htu`` ((tc, m, nG, g)).

    Per (u, G): ``Q = E_{m-1} ... E_0`` with ``E_j`` the window transform
    of sub-position j embedded at rows ``j*b``, composed in place so only S
    rows of Q change per j.  Zero reflectors (tau = 0) give exact
    identities.  ``tchunk`` composite steps at a time bound the
    transients."""
    tc, _, nG, _ = hvu.shape
    S = b + g
    S2 = g + m * b
    out = hvu.new_empty((tc, nG, S2, S2))
    eye = torch.eye(S2, dtype=hvu.dtype, device=hvu.device)
    for c0 in range(0, tc, tchunk):
        hv_c = hvu[c0:c0 + tchunk]
        ht_c = htu[c0:c0 + tchunk]
        B = hv_c.shape[0] * nG
        Q = out[c0:c0 + tchunk].view(B, S2, S2)
        Q.copy_(eye.expand(B, S2, S2))
        Q[:, :S, :S] -= _p_minus_i(hv_c[:, 0].reshape(B, g * b),
                                   ht_c[:, 0].reshape(B, g), g, b, S)
        for j in range(1, m):
            pj = _p_minus_i(hv_c[:, j].reshape(B, g * b),
                            ht_c[:, j].reshape(B, g), g, b, S)
            rows = Q[:, j * b:j * b + S]
            rows -= pj @ rows
    return out


class Plan(NamedTuple):
    """The geometry of one back-transform: n rows of z, bandwidth b, group
    g, composition depth m; nG groups, Tm composite positions, Tq2
    composite steps in nph phases of tc; z sits at rows [top, top + n) of
    a frame of ``rows`` rows."""
    n: int
    b: int
    g: int
    m: int
    nG: int
    Tm: int
    Tq2: int
    nph: int
    tc: int
    top: int
    rows: int


def plan(res: ChaseResult, z: torch.Tensor, group: int = 0,
         stream_bytes: int = 0) -> Plan:
    """The :class:`Plan` for ``z <- Q2 z`` (module doc for g and m); each
    phase holds at most ``stream_bytes`` (0 for :data:`STREAM_BYTES`) of
    the P stream, or one composite step where that is larger."""
    return plan_of(z.shape[0], res.HV.shape[2], res.HV.shape[1],
                   z.element_size(), group, stream_bytes)


def plan_of(n: int, b: int, T: int, itemsize: int, group: int = 0,
            stream_bytes: int = 0) -> Plan:
    """:func:`plan` from the shapes: n rows of z, bandwidth b, T band
    positions, ``itemsize`` bytes a word."""
    nsweeps = n - 2
    g = group or int(os.environ.get("EK_BT_GROUP", "0")) or 64
    g = min(g, nsweeps)
    nG = -(-nsweeps // g)
    m = max(1, min((128 - (b + g)) // b + 1, T))
    S2 = g + m * b
    Tm = -(-T // m)
    Tq2 = Tm + nG - 1
    nph = max(1, -(-Tq2 * nG * S2 * S2 * itemsize
                   // (stream_bytes or STREAM_BYTES)))
    tc = -(-Tq2 // min(nph, Tq2))      # at least one composite step a phase
    nph = -(-Tq2 // tc)
    # live windows start at frame rows >= 2 and end before top + n + S2
    top = g
    return Plan(n, b, g, m, nG, Tm, Tq2, nph, tc, top, top + n + S2)


def grid_stream_bytes(n: int, itemsize: int, parts: int) -> int:
    """The phase budget on a grid of ``parts`` ranks, each of which builds
    the whole P stream: :data:`STREAM_BYTES`, at most the bytes of an
    n x n matrix, shared by the ranks, so a rank's phase holds at most
    n^2 / parts words (or one composite step, where that is larger)."""
    return max(1, min(STREAM_BYTES, n * n * itemsize) // parts)


def stream_phases(res: ChaseResult, pl: Plan):
    """Yield ``(P, u0)`` per phase: the (tc, nG, S2, S2) transforms of
    composite steps [u0, u0 + tc)."""
    with events.span("bt:stream"):
        hvu, htu = _composite_views(*group_stores(res, pl.n, pl.b, pl.g),
                                    pl.m, pl.nph * pl.tc)
    for i in range(pl.nph):
        sl = slice(i * pl.tc, (i + 1) * pl.tc)
        with events.span("bt:stream"):
            P = _q_stream(hvu[sl], htu[sl], pl.g, pl.b, pl.m)
        yield P, i * pl.tc
        del P   # one phase alive at a time, once the consumer drops its P


def _live_lanes(pl: Plan, u: int):
    """(glo, ghi): the groups that apply a transform at composite step u.

    G <= u and u - G < Tm bound the wavefront ramps; a window starting at
    or past the end of z holds only zero reflectors (P = I), which bounds
    G from below: ``row0 < top + n  <=>  G > (m*b*u + K - n) / S2``."""
    S2 = pl.g + pl.m * pl.b
    K = pl.n - 1 - pl.g
    glo = max(0, u - (pl.Tm - 1), (pl.m * pl.b * u + K - pl.n) // S2 + 1)
    return glo, min(pl.nG - 1, u)


def apply_phase_plain(P: torch.Tensor, zp: torch.Tensor, pl: Plan,
                      u0: int) -> None:
    """The kernel's steps in PyTorch: per composite step, one bmm over the
    live lanes' windows (contiguous, S2 rows apart).  Updates the z frame
    ``zp`` in place."""
    S2 = pl.g + pl.m * pl.b
    K = pl.n - 1 - pl.g
    k = zp.shape[1]
    for uu in range(P.shape[0]):
        u = u0 + uu
        glo, ghi = _live_lanes(pl, u)
        if glo > ghi:
            continue
        nl = ghi - glo + 1
        r_lo = K - ghi * S2 + pl.m * pl.b * u + pl.top   # lane ghi's window
        zw = zp[r_lo:r_lo + nl * S2].view(nl, S2, k)
        pw = P[uu, glo:ghi + 1].flip(0)                  # lane ghi first
        zw.copy_(torch.bmm(pw, zw))


def apply_phase(P: torch.Tensor, zp: torch.Tensor, pl: Plan,
                u0: int) -> None:
    """Apply one phase of the P stream to the z frame ``zp`` in place: the
    CUDA kernel on a CUDA tensor, :func:`apply_phase_plain` on a CPU
    tensor."""
    global LAUNCHES, BRANCH
    if zp.device.type == "cpu":
        return apply_phase_plain(P, zp, pl, u0)
    if zp.device.type != "cuda":
        raise ValueError(f"apply_chase_q_wavefront: unsupported device "
                         f"{zp.device}")
    if not (P.is_contiguous() and zp.is_contiguous()):
        raise ValueError("apply_chase_q_wavefront: contiguous P and z frame "
                         "expected")
    lib = build.library()
    name = _FN[zp.dtype]
    launched, resident = ctypes.c_int(0), ctypes.c_int(0)
    stream = torch.cuda.current_stream(zp.device).cuda_stream
    status = getattr(lib, name)(P.data_ptr(), zp.data_ptr(), zp.shape[1],
                                pl.n, pl.b, pl.g, pl.m, pl.nG, pl.Tm, pl.top,
                                u0, P.shape[0], ctypes.byref(launched),
                                ctypes.byref(resident), stream)
    build.check(status, name)
    LAUNCHES += launched.value
    BRANCH = "resident" if resident.value else "streamed"


def frame(z: torch.Tensor, pl: Plan) -> torch.Tensor:
    """The zero-padded z frame the phases update."""
    zp = z.new_zeros((pl.rows, z.shape[1]))
    zp[pl.top:pl.top + pl.n] = z
    return zp


def _wavefront(res: ChaseResult, z: torch.Tensor, group: int, apply,
               stream_bytes: int = 0) -> torch.Tensor:
    n, k = z.shape
    if z.dtype not in _FN or res.HV.dtype != z.dtype:
        raise TypeError(f"apply_chase_q_wavefront: z {z.dtype} and the "
                        f"reflectors {res.HV.dtype} must be one of "
                        f"float32/float64")
    if z.device != res.HV.device:
        raise ValueError("apply_chase_q_wavefront: all operands on one "
                         "device")
    if z.device.type not in ("cpu", "cuda"):
        raise ValueError(f"apply_chase_q_wavefront: unsupported device "
                         f"{z.device}")
    if n <= 2 or res.HV.shape[2] < 2 or res.HV.shape[0] < n or k == 0:
        return z.clone()
    pl = plan(res, z, group, stream_bytes)
    zp = frame(z, pl)
    for P, u0 in stream_phases(res, pl):
        with events.span("bt:apply"):
            apply(P, zp, pl, u0)
        del P
    return zp[pl.top:pl.top + n].clone()


def apply_chase_q_wavefront_plain(res: ChaseResult, z: torch.Tensor,
                                  group: int = 0,
                                  stream_bytes: int = 0) -> torch.Tensor:
    """:func:`apply_chase_q_wavefront` by the plain version, on any
    device, in the same phases."""
    return _wavefront(res, z, group, apply_phase_plain, stream_bytes)


def apply_chase_q_wavefront(res: ChaseResult, z: torch.Tensor,
                            group: int = 0,
                            stream_bytes: int = 0) -> torch.Tensor:
    """``z <- Q2 z`` on the composite group wavefront (module doc).

    ``group`` (else ``EK_BT_GROUP``, else 64) is g; ``stream_bytes`` the
    byte budget of a phase of the P stream (0 for :data:`STREAM_BYTES`).
    A CUDA tensor runs the CUDA kernel, a CPU tensor the plain version.
    Returns a new tensor."""
    return _wavefront(res, z, group, apply_phase, stream_bytes)
