"""Tridiagonal divide and conquer (Cuppen), the pdstedc analog.

Counterpart of ``eigenkernel_tpu/ops/dc.py``, with the same algorithm:

* a bottom-up merge tree over ``base * 2^levels`` rows
  (:func:`_tree_shape`), the boundary-diagonal adjustments of every merge
  made up front, decoupled sentinel padding (e = 0 at the junction, so
  every padded coupling deflates exactly);
* leaves by one batched ``torch.linalg.eigh`` of the (nb, base, base)
  blocks; the merges of a level batched over a leading axis;
* per merge (:func:`_merge_one`): rank-one coupling with rho = |e_mid|,
  type-1 deflation by a mask, type-2 deflation (close poles) by a
  sequential scan that emits Givens records, compaction by a stable sort,
  all roots of the secular equation by safeguarded Newton with a rational
  step and geometric bisection (:func:`_secular_newton`),
  Gu-Eisenstat weights, the rotations replayed in reverse batched by
  chain depth, and the eigenvectors as two matrix products.

The two sequential scans of a merge (the type-2 deflation scan and the
chain depths of its rotations) are :func:`deflate_scan`: on a CUDA tensor
the hand-written kernel D1 (``csrc/dc_deflate.cu``), one launch a level;
on a CPU tensor :func:`deflate_scan_plain`, a Python loop over the steps
batched over the merges, in the kernel's arithmetic order.  Every other
step is PyTorch, which on the card runs the O(K^2) secular solve and the
products on cuBLAS.

Left out: ``EK_DC_UNROLL`` (an XLA scan knob) and the mesh paths.  The
secular solve materializes a few (nb, K, K) temporaries a level, 134 MB
each in float64 at the top of n = 4096.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from eigenkernel_tpu_torch.ops import build

LAUNCHES = 0  # launches of D1 by deflate_scan (CPU tensors do not count)

_FN = {torch.float64: "ek_dc_deflate_f64",
       torch.float32: "ek_dc_deflate_f32"}


class Deflation(NamedTuple):
    """The deflation scans of the nb merges of a level, each of K steps.

    Per step (nb, K): the entry finalized at that step (``fin_idx``,
    ``fin_d``, ``fin_u``, ``fin_valid``), the rotation record (``rot_ip``,
    ``rot_i``, ``rot_c``, ``rot_s``, ``rot_m``) and its chain depth
    (``depths``, -1 where ``rot_m`` is false).  Per merge (nb,): the final
    carry (``has_p``, ``ip``, ``dp``, ``up``), the last survivor."""

    fin_idx: torch.Tensor
    fin_d: torch.Tensor
    fin_u: torch.Tensor
    fin_valid: torch.Tensor
    rot_ip: torch.Tensor
    rot_i: torch.Tensor
    rot_c: torch.Tensor
    rot_s: torch.Tensor
    rot_m: torch.Tensor
    has_p: torch.Tensor
    ip: torch.Tensor
    dp: torch.Tensor
    up: torch.Tensor
    depths: torch.Tensor


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root, which CUDA's ``sqrt`` and the
    kernel give: PyTorch's CPU kernel can be one ulp off, numpy's is
    exact."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def deflate_scan_plain(ds: torch.Tensor, us: torch.Tensor,
                       alive: torch.Tensor, tol: torch.Tensor) -> Deflation:
    """The kernel's two scans in PyTorch, one step at a time over the K
    entries, batched over the nb merges.

    Type-2 deflation (dlaed2): the carry holds the last surviving entry
    (ip, dp, up); entry i, if alive, is rotated into it when the coupling
    |(d_i - dp) c s| of the Givens pair (c, s) = (u_i, up) / r is at most
    ``tol``.  A rotation's chain depth is one more than the previous
    rotation's where that one's survivor is this one's partner, else 0.
    Products and sums are written out one rounding at a time, the order
    the kernel keeps.
    """
    nb, K = ds.shape
    dtype, dev = ds.dtype, ds.device
    has = torch.zeros(nb, dtype=torch.bool, device=dev)
    ip = torch.zeros(nb, dtype=torch.int64, device=dev)
    dp = torch.zeros(nb, dtype=dtype, device=dev)
    up = torch.zeros(nb, dtype=dtype, device=dev)
    last_i = torch.full((nb,), -1, dtype=torch.int64, device=dev)
    last_d = torch.zeros(nb, dtype=torch.int64, device=dev)
    rec = {f: [] for f in ("fin_idx", "fin_d", "fin_u", "fin_valid",
                           "rot_ip", "rot_c", "rot_s", "rot_m", "depths")}
    for i in range(K):
        di, ui, al = ds[:, i], us[:, i], alive[:, i]
        r = sqrt_rn(up * up + ui * ui)
        r_safe = torch.where(r == 0, 1.0, r)
        c = ui / r_safe
        sn = up / r_safe
        close = has & al & (((di - dp) * c * sn).abs() <= tol)
        fin_prev = has & al & ~close
        fin_self = ~al
        rec["fin_valid"].append(close | fin_prev | fin_self)
        rec["fin_idx"].append(torch.where(fin_self, i, ip))
        rec["fin_d"].append(torch.where(
            close, c * c * dp + sn * sn * di, torch.where(fin_self, di, dp)))
        rec["fin_u"].append(torch.where(fin_prev, up, 0.0))
        rec["rot_ip"].append(ip)
        rec["rot_c"].append(c)
        rec["rot_s"].append(sn)
        rec["rot_m"].append(close)
        depth = torch.where(close & (ip == last_i), last_d + 1, 0)
        rec["depths"].append(torch.where(close, depth, -1))
        last_i = torch.where(close, i, last_i)
        last_d = torch.where(close, depth, last_d)
        has = has | al
        dp = torch.where(al, torch.where(close, sn * sn * dp + c * c * di,
                                         di), dp)
        up = torch.where(al, torch.where(close, r, ui), up)
        ip = torch.where(al, i, ip)
    out = {f: torch.stack(v, dim=1) for f, v in rec.items()}
    rot_i = torch.arange(K, device=dev).expand(nb, K).contiguous()
    return Deflation(rot_i=rot_i, has_p=has, ip=ip, dp=dp, up=up, **out)


def _check(ds, us, alive, tol):
    if ds.dtype not in _FN:
        raise TypeError(f"deflate_scan: dtype {ds.dtype} not "
                        f"float32/float64")
    if ds.dim() != 2 or us.shape != ds.shape or alive.shape != ds.shape:
        raise ValueError("deflate_scan: ds, us and alive must be (nb, K)")
    if ds.shape[1] < 1:
        raise ValueError("deflate_scan: K must be >= 1")
    if tol.shape != ds.shape[:1]:
        raise ValueError(f"deflate_scan: tol must be (nb,) = "
                         f"({ds.shape[0]},), got {tuple(tol.shape)}")
    if us.dtype != ds.dtype or tol.dtype != ds.dtype:
        raise TypeError("deflate_scan: ds, us and tol must share a dtype")
    if alive.dtype != torch.bool:
        raise TypeError(f"deflate_scan: alive must be bool, got "
                        f"{alive.dtype}")
    for t in (us, alive, tol):
        if t.device != ds.device:
            raise ValueError("deflate_scan: all operands on one device")


def deflate_scan(ds: torch.Tensor, us: torch.Tensor, alive: torch.Tensor,
                 tol: torch.Tensor) -> Deflation:
    """Both deflation scans of a level's merges (:class:`Deflation`).

    ds, us (nb, K): each merge's poles (ascending) and rank-one weights;
    alive (nb, K) bool: not type-1 deflated; tol (nb,): the coupling
    tolerance.  A CUDA tensor runs the kernel D1, a CPU tensor the plain
    version.
    """
    _check(ds, us, alive, tol)
    if ds.device.type == "cpu":
        return deflate_scan_plain(ds, us, alive, tol)
    if ds.device.type != "cuda":
        raise ValueError(f"deflate_scan: unsupported device {ds.device}")
    return _launch(ds, us, alive, tol)


def _launch(ds, us, alive, tol) -> Deflation:
    """D1 on checked CUDA operands: one CTA a merge, every step speculated
    at once and the steps after each close one resolved by a warp."""
    global LAUNCHES
    nb, K = ds.shape
    dtype, dev = ds.dtype, ds.device
    vals = torch.empty((4, nb, K), dtype=dtype, device=dev)
    idx = torch.empty((4, nb, K), dtype=torch.int64, device=dev)
    flags = torch.empty((2, nb, K), dtype=torch.bool, device=dev)
    carry_v = torch.empty((2, nb), dtype=dtype, device=dev)
    carry_i = torch.empty(nb, dtype=torch.int64, device=dev)
    carry_f = torch.empty(nb, dtype=torch.bool, device=dev)
    ds, us = ds.contiguous(), us.contiguous()
    alive, tol = alive.contiguous(), tol.contiguous()
    lib = build.library()
    name = _FN[dtype]
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = getattr(lib, name)(
        ds.data_ptr(), us.data_ptr(), alive.data_ptr(), tol.data_ptr(), nb,
        K, vals.data_ptr(), idx.data_ptr(), flags.data_ptr(),
        carry_v.data_ptr(), carry_i.data_ptr(), carry_f.data_ptr(), stream)
    build.check(status, name)
    LAUNCHES += 1
    return Deflation(fin_idx=idx[0], fin_d=vals[0], fin_u=vals[1],
                     fin_valid=flags[0], rot_ip=idx[1], rot_i=idx[2],
                     rot_c=vals[2], rot_s=vals[3], rot_m=flags[1],
                     has_p=carry_f, ip=carry_i, dp=carry_v[0],
                     up=carry_v[1], depths=idx[3])


def _secular_newton(dc, uc, rho, m, iters: int):
    """All roots of ``1 + rho sum_i uc_i^2 / (dc_i - lam)`` of each merge.

    dc, uc (nb, K): compacted (active first, dc ascending); rho, m (nb,):
    the coupling and the count of active entries.  Lane j < m finds the
    root between dc_j and the next pole; lanes j >= m are masked.  Returns
    (anchor, mu, dd): root = anchor + mu with anchor the nearer of the two
    bracketing poles, dd[b, i, j] = dc_i - anchor_j (exact pole gaps).
    """
    nb, K = dc.shape
    dtype, dev = dc.dtype, dc.device
    tiny = torch.finfo(dtype).tiny
    jm = torch.arange(K, device=dev)
    mm = m[:, None]
    act = jm[None, :] < mm
    rho_ = rho[:, None]
    u2 = uc * uc
    usum2 = u2.sum(dim=1, keepdim=True)
    d_last = dc.gather(1, (mm - 1).clamp(0, K - 1))
    d_nxt = dc[:, (jm + 1).clamp(max=K - 1)]
    # right interval edge: the next pole, or d_max + rho ||u||^2 for the
    # last root
    d_next = torch.where(jm[None, :] + 1 < mm, d_nxt,
                         d_last + rho_ * usum2 + tiny)
    delta = torch.clamp(d_next - dc, min=tiny)
    terms = u2[:, :, None]                  # (nb, K terms, 1)
    dead = terms == 0

    def f_and_fp(den, want_fp=True):
        # f and f' at every lane from den[b, i, j] = pole_i - lam_j
        den.masked_fill_(dead, 1.0)
        f = 1.0 + rho_ * (terms / den).sum(dim=1)
        if not want_fp:
            return f, None
        fp = rho_ * (terms / den.mul_(den)).sum(dim=1)
        return f, fp

    mid = dc + 0.5 * delta
    fmid, _ = f_and_fp(dc[:, :, None] - mid[:, None, :], want_fp=False)
    last = jm[None, :] == mm - 1
    # anchor at the nearer pole; the last interval always anchors left
    right = (fmid < 0) & ~last
    anchor = torch.where(right, d_next, dc)
    dd = dc[:, :, None] - anchor[:, None, :]
    # solve in a = |mu|, the distance from the anchor: g(a) = +-f is
    # increasing in a (see the JAX module for the safeguards)
    sgn = torch.where(right, -1.0, 1.0).to(dtype)
    last_neg = last & (fmid < 0)
    lo = torch.where(last_neg, 0.5 * delta, 0.0)
    hi = torch.where(last_neg, delta, 0.5 * delta)
    anc_idx = torch.where(right, jm + 1, jm).clamp(0, K - 1)
    u_anc2 = u2.gather(1, anc_idx)
    rho_u = rho_ * u_anc2

    a = 0.5 * (lo + hi)
    for i in range(iters):
        f, fp = f_and_fp(dd - (sgn * a)[:, None, :])
        g = sgn * f
        below = g < 0                     # a is left of the root
        # a root where g rounds to exactly 0 stays: the steps below would
        # reject it (hi moves onto it, so it is not inside (lo, hi)) and
        # fall back to sqrt(lo hi), off the root
        hit = g == 0
        lo = torch.where(below, a, lo)
        hi = torch.where(below, hi, a)
        fallback = torch.where(lo > 0, torch.sqrt(lo * hi), hi * 2.0 ** -32)
        # odd iterations force the geometric bisection (global
        # convergence); the smart steps give the final relative precision
        if i % 2 == 1 and i < iters - 12:
            a = torch.where(hit, a, fallback)
            continue
        # one-pole rational model: a <- rho u_anc^2 / S with S the smooth
        # rest of g frozen
        s = g + rho_u / a
        a_rat = rho_u / s
        ok_r = (s > 0) & torch.isfinite(a_rat) & (a_rat > lo) & (a_rat < hi)
        a_n = a - g / torch.where(fp == 0, 1.0, fp)
        ok_n = (a_n > lo) & (a_n < hi) & torch.isfinite(a_n) & (fp > 0)
        a = torch.where(hit, a, torch.where(ok_r, a_rat,
                                            torch.where(ok_n, a_n, fallback)))
    mu = torch.where(act, sgn * a, 0.0)
    return anchor, mu, dd


def _merge_one(w1, w2, q1, q2, e_mid, iters: int):
    """Merge the solved halves of nb merges across their couplings.

    w1, w2 (nb, K2): ascending eigenvalues of the (pre-adjusted) halves;
    q1, q2 (nb, K2, K2): their eigenvectors; e_mid (nb,): the subdiagonal
    entries joining them.  Returns (w, q) of the unions, w (nb, K)
    ascending and q (nb, K, K) = blkdiag(q1, q2) S.
    """
    nb, K2 = w1.shape
    K = 2 * K2
    dtype, dev = w1.dtype, w1.device
    eps = torch.finfo(dtype).eps
    tiny = torch.finfo(dtype).tiny
    rho = e_mid.abs()
    s_sign = torch.where(e_mid >= 0, 1.0, -1.0).to(dtype)

    d = torch.cat([w1, w2], dim=1)
    u = torch.cat([q1[:, K2 - 1, :], s_sign[:, None] * q2[:, 0, :]], dim=1)
    sortp = torch.argsort(d, dim=1, stable=True)
    ds = d.gather(1, sortp)
    us = u.gather(1, sortp)

    scale = torch.maximum(ds.abs().amax(dim=1), rho)
    tol = 8.0 * eps * scale.clamp(min=tiny)
    alive = rho[:, None] * us.abs() > tol[:, None]   # not type-1 deflated

    # type-2 deflation scan and rotation chain depths (kernel D1)
    df = deflate_scan(ds, us, alive, tol)
    # finalized entries and the last survivor into a buffer one column
    # wider: column K takes the dropped writes
    drop = torch.where(df.fin_valid, df.fin_idx, K)
    flush = torch.where(df.has_p, df.ip, K)[:, None]
    d2 = torch.cat([ds, ds.new_zeros(nb, 1)], dim=1)
    d2.scatter_(1, drop, df.fin_d).scatter_(1, flush, df.dp[:, None])
    u2 = torch.zeros_like(d2)
    u2.scatter_(1, drop, df.fin_u).scatter_(1, flush, df.up[:, None])
    d2, u2 = d2[:, :K], u2[:, :K]

    active = u2 != 0
    m = active.sum(dim=1)
    # compact: active first, d order preserved
    pi = torch.argsort((~active).to(torch.int32), dim=1, stable=True)
    dc = d2.gather(1, pi)
    uc = u2.gather(1, pi)

    anchor, mu, dd = _secular_newton(dc, uc, rho, m, iters)
    jm = torch.arange(K, device=dev)
    act = jm[None, :] < m[:, None]
    both_act = act[:, :, None] & act[:, None, :]
    eye = torch.eye(K, dtype=torch.bool, device=dev)
    valid = both_act & ~eye

    # Gu/Eisenstat weights: uhat_i^2 = prod_j (lam_j - dc_i) /
    # (rho prod_{j != i} (dc_j - dc_i)), paired j <-> j
    lam_m_d = mu[:, None, :] - dd                  # lam_j - dc_i
    neg_gap = dc[:, None, :] - dc[:, :, None]      # dc_j - dc_i
    ratio = torch.where(valid, lam_m_d / torch.where(valid, neg_gap, 1.0),
                        1.0)
    del neg_gap
    prod = ratio.prod(dim=2)
    del ratio
    diag_term = lam_m_d.diagonal(dim1=1, dim2=2)
    uhat2 = torch.where(act, diag_term * prod
                        / torch.where(rho == 0, 1.0, rho)[:, None], 0.0)
    del lam_m_d
    uhat = torch.sqrt(uhat2.clamp(min=0.0))
    uhat = torch.where(uc < 0, -uhat, uhat)

    # eigenvectors in compacted space: S[i, j] = uhat_i / (dc_i - lam_j)
    den = torch.where(both_act, dd - mu[:, None, :], 1.0)
    del dd
    s = torch.where(both_act, uhat[:, :, None] / den,
                    eye.to(dtype).expand(nb, K, K))
    del den
    s = s / torch.linalg.vector_norm(s, dim=1, keepdim=True)
    lam_all = torch.where(act, anchor + mu, dc)

    # un-compact rows (compacted -> sorted order), one junk row below
    spad = torch.zeros((nb, K + 1, K), dtype=dtype, device=dev)
    spad.scatter_(1, pi[:, :, None].expand(nb, K, K), s)
    del s
    # replay the type-2 rotations in reverse (G^T on row pairs), batched
    # by chain depth: the rotations of one depth touch disjoint rows.  One
    # host read of the deepest chain a level; no pass when nothing
    # deflated type-2.
    maxd = int(df.depths.max())
    for depth in range(maxd, -1, -1):
        sel = df.depths == depth
        i1 = torch.where(sel, df.rot_ip, K)[:, :, None].expand(nb, K, K)
        i2 = torch.where(sel, df.rot_i, K)[:, :, None].expand(nb, K, K)
        cb = torch.where(sel, df.rot_c, 1.0)[:, :, None]
        sb = torch.where(sel, df.rot_s, 0.0)[:, :, None]
        r1 = spad.gather(1, i1)
        r2 = spad.gather(1, i2)
        spad.scatter_(1, i1, cb * r1 + sb * r2)
        spad.scatter_(1, i2, -sb * r1 + cb * r2)
        del r1, r2
    # un-sort rows (sorted -> concatenated order)
    s_o = torch.empty((nb, K, K), dtype=dtype, device=dev)
    s_o.scatter_(1, sortp[:, :, None].expand(nb, K, K), spad[:, :K])
    del spad
    # sort the columns by eigenvalue
    cperm = torch.argsort(lam_all, dim=1, stable=True)
    w = lam_all.gather(1, cperm)
    s_o = s_o.gather(2, cperm[:, None, :].expand(nb, K, K))
    q = torch.cat([q1 @ s_o[:, :K2, :], q2 @ s_o[:, K2:, :]], dim=1)
    return w, q


def _tree_shape(n: int, leaf_target: int = 64):
    """(base, levels) with base * 2^levels >= n and small padding."""
    if n <= leaf_target:
        return n, 0
    levels = 1
    while leaf_target * (1 << levels) < n:
        levels += 1
    base = -(-n // (1 << levels))            # ceil
    base = -(-base // 8) * 8                 # round to 8
    return base, levels


def tridiag_dc(d: torch.Tensor, e: torch.Tensor,
               iters: Optional[int] = None):
    """All eigenpairs of the symmetric tridiagonal (d, e) by batched
    divide and conquer.  Returns (w, q): w (n,) ascending, q (n, n)
    orthonormal columns.  ``iters`` safeguarded Newton steps a root:
    ``EK_DC_ITERS``, else 60 in float64 and 30 in float32."""
    n = d.shape[0]
    dtype, dev = d.dtype, d.device
    if iters is None:
        iters = int(os.environ.get("EK_DC_ITERS", "0")) or \
            (60 if dtype == torch.float64 else 30)
    base, levels = _tree_shape(n)
    N = base << levels

    if N > n:
        # decoupled sentinel padding: e = 0 at the junction makes every
        # padded coupling rho exactly 0, so it deflates fully.  The pads
        # lie in [3 span, 6 span), above the spectrum (|lambda| <= 2 span)
        # but near it: every merge's deflation tolerance scales with its
        # largest pole, and the JAX function's pads (3 span + 1) (1 + j)
        # raise it (N - n)-fold, to residuals of 1e-4 in float32 at n = 300
        span = d.abs().max() + (e.abs().max() if n > 1 else 0.0)
        big = torch.where(span > 0, 3.0 * span, 1.0)
        pad = big * (1.0 + torch.arange(N - n, dtype=dtype, device=dev)
                     / (N - n))
        d = torch.cat([d, pad])
        e = torch.cat([e, e.new_zeros(N - n + 1)])[:N - 1]
    e_full = torch.cat([e, e.new_zeros(1)])            # (N,)

    # the boundary-diagonal adjustments of every merge of every level:
    # subtract |e_mid| from both middle entries
    d_adj = d.clone()
    for lvl in range(1, levels + 1):
        half = base << (lvl - 1)
        mids = torch.arange(N // (2 * half), device=dev) * (2 * half) + half
        rho_l = e_full[mids - 1].abs()
        d_adj[mids - 1] -= rho_l
        d_adj[mids] -= rho_l

    # leaves: one batched dense eigh of the (nb, base, base) blocks
    nb = N // base
    t = torch.diag_embed(d_adj.reshape(nb, base))
    if base > 1:
        eb = e_full.reshape(nb, base)[:, :base - 1]
        t = t + torch.diag_embed(eb, 1) + torch.diag_embed(eb, -1)
    w, q = torch.linalg.eigh(t)
    del t

    # bottom-up merges, all of a level at once
    for lvl in range(1, levels + 1):
        K2 = base << (lvl - 1)
        nb = N // (2 * K2)
        w = w.reshape(nb, 2, K2)
        q = q.reshape(nb, 2, K2, K2)
        mids = torch.arange(nb, device=dev) * (2 * K2) + K2
        w, q = _merge_one(w[:, 0], w[:, 1], q[:, 0], q[:, 1],
                          e_full[mids - 1], iters)
    return w.reshape(N)[:n], q.reshape(N, N)[:n, :n]
