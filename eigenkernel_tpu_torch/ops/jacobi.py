"""Two-sided block-Jacobi symmetric eigensolver (the ``jacobi`` core).

Counterpart of ``eigenkernel_tpu/ops/jacobi.py``.  The matrix is cut into
nb block rows of width b; a round-robin tournament (:func:`_tournament`,
the circle method) pairs all blocks disjointly in nb - 1 rounds a sweep.
A round diagonalizes the m = nb / 2 pair blocks (2b x 2b) at once
(:func:`pair_eigh`), orders each rotation's columns closest to the
identity, makes it orthogonal to working precision by one Newton-Schulz
step, and applies the block rotations as three batched products (rows,
columns, eigenvector accumulation).

Any n: where 2b does not divide n, the matrix is padded to the next
multiple of 2b with decoupled sentinel diagonal entries above the
spectrum (``ops/blocked.gershgorin_sentinel``).  Their couplings are
exact zeros, which no rotation ever mixes into a live index, so the
sentinel pairs sort last and are dropped.  The JAX function instead picks
a smaller b, and falls back to a dense eigh where none fits; this one
never does.

The pair eigh is the hand-written kernel D2 (``csrc/pair_jacobi.cu``) on a
CUDA tensor, one launch a round, and its plain version
:func:`pair_eigh_plain` on a CPU tensor: a two-sided cyclic Jacobi in the
parallel round-robin order on each pair block, written in the kernel's
arithmetic order.  The JAX package calls a library eigh there; this is
no port of a TPU kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from eigenkernel_tpu_torch.ops import build
from eigenkernel_tpu_torch.ops.blocked import gershgorin_sentinel
from eigenkernel_tpu_torch.ops.dc import sqrt_rn

LAUNCHES = 0  # launches of D2 by pair_eigh (CPU tensors do not count)
MAX_SWEEPS = 15  # inner Jacobi sweeps a pair block at most

_FN = {torch.float64: "ek_pair_jacobi_f64",
       torch.float32: "ek_pair_jacobi_f32"}


class PairEigh(NamedTuple):
    """Eigenpairs of a batch of m symmetric w x w blocks.

    values (m, w): the diagonal left by the rotations, in Jacobi order (not
    sorted); vectors (m, w, w): orthogonal, column j belonging to
    values[:, j]; sweeps (m,) int32: the sweeps each block ran, the last
    one without a rotation unless the cap was reached; rotations (m,)
    int32: the rotations each block applied."""

    values: torch.Tensor
    vectors: torch.Tensor
    sweeps: torch.Tensor
    rotations: torch.Tensor


def _tournament(nb: int) -> np.ndarray:
    """Round-robin pairings: (nb-1, nb//2, 2) covering all blocks each
    round (circle method, block 0 fixed)."""
    assert nb % 2 == 0
    others = list(range(1, nb))
    rounds = []
    for _ in range(nb - 1):
        ring = [0] + others
        pairs = [(ring[i], ring[nb - 1 - i]) for i in range(nb // 2)]
        rounds.append(pairs)
        others = others[1:] + others[:1]
    return np.asarray(rounds, np.int32)


def _pair_rows(pairs: np.ndarray, b: int) -> np.ndarray:
    """(rounds, m, 2b) global row indices of each pair's block rows."""
    r = np.arange(b, dtype=np.int32)
    return np.concatenate([pairs[..., 0:1] * b + r,
                           pairs[..., 1:2] * b + r], axis=-1)


def pair_sets(w: int) -> np.ndarray:
    """The inner sweep's order for a w x w block: (W - 1, W / 2, 2) index
    pairs p < q, W = w rounded up to even, set r being round r of
    :func:`_tournament` (W); a pair with q = w (odd w) is a bye.  The
    kernel computes the same pairs from (W, r, i)."""
    ww = w + (w & 1)
    return np.sort(_tournament(ww), axis=-1)


def _rotate(x: torch.Tensor, p, q, c, s, rot) -> None:
    """x[..., p, :], x[..., q, :] <- c x_p - s x_q, s x_p + c x_q where
    ``rot``, in place; c, s, rot (m, P)."""
    xp, xq = x[:, p, :], x[:, q, :]
    cc, ss, keep = c[:, :, None], s[:, :, None], rot[:, :, None]
    x[:, p, :] = torch.where(keep, cc * xp - ss * xq, xp)
    x[:, q, :] = torch.where(keep, ss * xp + cc * xq, xq)


def pair_eigh_plain(a: torch.Tensor) -> PairEigh:
    """D2's cyclic Jacobi in PyTorch, batched over the m blocks of ``a``
    (m, w, w), one set of disjoint rotations at a time.

    Per pair (p, q) of a set (:func:`pair_sets`): skipped, with a_pq and
    a_qp set to exactly 0, when |a_pq| <= eps sqrt(|a_pp a_qq|); else the
    Rutishauser rotation tau = (a_qq - a_pp) / (2 a_pq), t = sign(tau) /
    (|tau| + sqrt(1 + tau^2)), c = 1 / sqrt(1 + t^2), s = t c, applied to
    the rows, then the columns (a_pq, a_qp set to exactly 0), then V.  A
    block stops after a sweep without a rotation, or after MAX_SWEEPS.
    Each product and sum rounds on its own, square roots correctly
    rounded: the order the kernel keeps, so the two agree bit for bit.
    """
    m, w = a.shape[0], a.shape[1]
    dtype, dev = a.dtype, a.device
    A = a.clone()
    vt = torch.eye(w, dtype=dtype, device=dev).expand(m, w, w).clone()
    sweeps = torch.zeros(m, dtype=torch.int32, device=dev)
    rotations = torch.zeros(m, dtype=torch.int32, device=dev)
    eps = torch.finfo(dtype).eps
    active = torch.ones(m, dtype=torch.bool, device=dev)
    sets = []
    for st in torch.as_tensor(pair_sets(w), dtype=torch.int64, device=dev):
        st = st[st[:, 1] < w]                   # drop an odd w's bye
        sets.append((st[:, 0], st[:, 1]))
    for _ in range(MAX_SWEEPS):
        sweeps += active.to(torch.int32)
        before = rotations.clone()
        act = active[:, None]
        for p, q in sets:
            app, aqq, apq = A[:, p, p], A[:, q, q], A[:, p, q]
            thr = eps * sqrt_rn((app * aqq).abs())
            rot = act & (apq.abs() > thr)
            tau = (aqq - app) / (2.0 * apq)
            sign = torch.where(tau >= 0, 1.0, -1.0).to(dtype)
            t = sign / (tau.abs() + sqrt_rn(1.0 + tau * tau))
            c = 1.0 / sqrt_rn(1.0 + t * t)
            s = t * c
            _rotate(A, p, q, c, s, rot)
            _rotate(A.transpose(1, 2), p, q, c, s, rot)
            A[:, p, q] = torch.where(act, 0.0, A[:, p, q])
            A[:, q, p] = torch.where(act, 0.0, A[:, q, p])
            _rotate(vt, p, q, c, s, rot)
            rotations += rot.sum(dim=1, dtype=torch.int32)
        active &= rotations != before
        if not bool(active.any()):
            break
    return PairEigh(values=A.diagonal(dim1=1, dim2=2).clone(),
                    vectors=vt.transpose(1, 2), sweeps=sweeps,
                    rotations=rotations)


def _check(a: torch.Tensor) -> None:
    if a.dtype not in _FN:
        raise TypeError(f"pair_eigh: dtype {a.dtype} not float32/float64")
    if a.dim() != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"pair_eigh: a must be (m, w, w), got "
                         f"{tuple(a.shape)}")
    if a.shape[0] < 1 or a.shape[1] < 1:
        raise ValueError("pair_eigh: m and w must be >= 1")


def pair_eigh(a: torch.Tensor) -> PairEigh:
    """Eigenpairs of the symmetric blocks ``a`` (m, w, w)
    (:class:`PairEigh`).  A CUDA tensor runs the kernel D2, a CPU tensor
    the plain version."""
    _check(a)
    if a.device.type == "cpu":
        return pair_eigh_plain(a)
    if a.device.type != "cuda":
        raise ValueError(f"pair_eigh: unsupported device {a.device}")
    return _launch(a)


def smem_bytes(w: int, itemsize: int) -> tuple:
    """(dynamic shared memory bytes, A resident, V resident) of D2's
    launch at width w: the source's ``ek_pair_jacobi_smem`` and
    ``ek_pair_jacobi_resident``."""
    lib = build.library()
    flags = lib.ek_pair_jacobi_resident(w, itemsize)
    return lib.ek_pair_jacobi_smem(w, itemsize), bool(flags & 1), \
        bool(flags & 2)


def _launch(a: torch.Tensor) -> PairEigh:
    """D2 on a checked CUDA batch: one CTA a block."""
    global LAUNCHES
    m, w = a.shape[0], a.shape[1]
    dtype, dev = a.dtype, a.device
    a = a.contiguous()
    _, a_res, _ = smem_bytes(w, a.element_size())
    values = torch.empty((m, w), dtype=dtype, device=dev)
    vt = torch.empty((m, w, w), dtype=dtype, device=dev)
    counts = torch.empty((2, m), dtype=torch.int32, device=dev)
    # the rotated blocks live in shared memory where they fit, else here
    work = None if a_res else torch.empty((m, w, w + 1), dtype=dtype,
                                          device=dev)
    lib = build.library()
    name = _FN[dtype]
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = getattr(lib, name)(
        a.data_ptr(), m, w, MAX_SWEEPS, values.data_ptr(), vt.data_ptr(),
        counts.data_ptr(), 0 if work is None else work.data_ptr(), stream)
    build.check(status, name)
    LAUNCHES += 1
    return PairEigh(values=values, vectors=vt.transpose(1, 2),
                    sweeps=counts[0], rotations=counts[1])


def _rot_rows(x: torch.Tensor, rows: torch.Tensor, rot: torch.Tensor):
    """x[rows(pair), :] <- rot^T @ x[rows(pair), :], batched over the
    pairs, in place (``x`` may be a transposed view)."""
    m, w2 = rot.shape[0], rot.shape[1]
    blk = x.index_select(0, rows).view(m, w2, -1)
    x.index_copy_(0, rows, torch.bmm(rot.transpose(1, 2), blk)
                  .view(m * w2, -1))


def block_jacobi_eigh(a: torch.Tensor, block: int = 64, sweeps: int = 0):
    """Full eigendecomposition by block Jacobi.  Returns (w, v) ascending.

    ``sweeps=0`` picks the dtype's default, 12 float64 / 8 float32, as in
    the JAX function (degenerate spectra need the extra sweeps).
    """
    n = a.shape[0]
    dtype, dev = a.dtype, a.device
    if n == 1:
        return a.diagonal().clone(), torch.ones_like(a)
    b = max(1, min(block, n // 2))
    big = -(-n // (2 * b)) * (2 * b)
    x = a.new_zeros((big, big))
    x[:n, :n] = a
    if big > n:
        x[n:, n:].diagonal().fill_(float(gershgorin_sentinel(a)))
    nb = big // b
    if sweeps <= 0:
        sweeps = 12 if dtype == torch.float64 else 8
    rows_tab = torch.as_tensor(_pair_rows(_tournament(nb), b),
                               dtype=torch.int64, device=dev)
    n_rounds = rows_tab.shape[0]
    v = torch.eye(big, dtype=dtype, device=dev)
    for it in range(sweeps * n_rounds):
        rows = rows_tab[it % n_rounds]                      # (m, 2b)
        sub = x[rows[:, :, None], rows[:, None, :]]         # (m, 2b, 2b)
        rot = pair_eigh((sub + sub.transpose(1, 2)) * 0.5).vectors
        # columns in the order of their largest entry's row: the identity
        # stays the fixed point of an already diagonal pair block
        key = rot.abs().argmax(dim=1)                       # (m, 2b)
        cperm = torch.argsort(key, dim=1, stable=True)
        rot = torch.gather(rot, 2, cperm[:, None, :].expand_as(rot))
        # one Newton-Schulz step, rot (3 I - rot^T rot) / 2: the kernel's
        # rotations, products of some w^2 plane rotations each rounded on
        # its own, are orthogonal to ~1e-14 (a library eigh's to ~3e-15),
        # and without the step the spectrum drifts by ~1e-13 ||A|| over
        # the rounds; two (m, 2b, 2b) products, ~2 % of a round's work
        rot = 1.5 * rot - 0.5 * torch.bmm(rot, torch.bmm(rot.transpose(1, 2),
                                                         rot))
        flat = rows.reshape(-1)
        _rot_rows(x, flat, rot)
        _rot_rows(x.T, flat, rot)                           # two-sided
        _rot_rows(v.T, flat, rot)                           # V <- V G
    d = x.diagonal()
    perm = torch.argsort(d, stable=True)[:n]   # the sentinels sort last
    return d[perm], v[:n, perm]
