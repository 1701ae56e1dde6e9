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
CUDA tensor, one launch a round (a cluster of two CTAs a block: A and the
rotation chain on one SM, V^T on the other), and its plain version
:func:`pair_eigh_plain` on a CPU tensor: a two-sided cyclic Jacobi in the
parallel round-robin order on each pair block, written in the kernel's
arithmetic order.  The JAX package calls a library eigh there; this is
no port of a TPU kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from eigenkernel_tpu_torch.ops import build
from eigenkernel_tpu_torch.ops.blocked import gershgorin_sentinel
from eigenkernel_tpu_torch.ops.dc import sqrt_rn
from eigenkernel_tpu_torch.parallel import mesh as pm

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
    On a CUDA tensor each sweep replays one CUDA graph of its operations
    (a launch a sweep, not ~25 a set), the stop read after it.
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

    def sweep():
        _sweep(A, vt, rotations, active, sets, eps)

    if a.is_cuda:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            sweep()
        sweep = graph.replay
    for _ in range(MAX_SWEEPS):
        sweeps += active.to(torch.int32)
        before = rotations.clone()
        sweep()
        active &= rotations != before
        if not bool(active.any()):
            break
    return PairEigh(values=A.diagonal(dim1=1, dim2=2).clone(),
                    vectors=vt.transpose(1, 2), sweeps=sweeps,
                    rotations=rotations)


def _sweep(A, vt, rotations, active, sets, eps: float) -> None:
    """One sweep of the sets on the active blocks, in place."""
    act = active[:, None]
    dtype = A.dtype
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
    """(dynamic shared memory bytes of each CTA, A resident in CTA 0,
    V^T resident in CTA 1) of D2's launch at width w: the source's
    ``ek_pair_jacobi_smem`` and ``ek_pair_jacobi_resident``."""
    lib = build.library()
    flags = lib.ek_pair_jacobi_resident(w, itemsize)
    return lib.ek_pair_jacobi_smem(w, itemsize), bool(flags & 1), \
        bool(flags & 2)


def _launch(a: torch.Tensor) -> PairEigh:
    """D2 on a checked CUDA batch: a cluster of two CTAs a block."""
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


def _rotations(sub: torch.Tensor) -> torch.Tensor:
    """A round's block rotations from its pair blocks ``sub`` (m, 2b, 2b):
    the pair eigh's vectors (kernel D2 on a CUDA tensor), columns ordered
    closest to the identity, made orthogonal by one Newton-Schulz step."""
    rot = pair_eigh((sub + sub.transpose(1, 2)) * 0.5).vectors
    # columns in the order of their largest entry's row: the identity
    # stays the fixed point of an already diagonal pair block
    key = rot.abs().argmax(dim=1)                           # (m, 2b)
    cperm = torch.argsort(key, dim=1, stable=True)
    rot = torch.gather(rot, 2, cperm[:, None, :].expand_as(rot))
    # one Newton-Schulz step, rot (3 I - rot^T rot) / 2: the kernel's
    # rotations, products of some w^2 plane rotations each rounded on
    # its own, are orthogonal to ~1e-14 (a library eigh's to ~3e-15),
    # and without the step the spectrum drifts by ~1e-13 ||A|| over
    # the rounds; two (m, 2b, 2b) products, ~2 % of a round's work
    return 1.5 * rot - 0.5 * torch.bmm(rot, torch.bmm(rot.transpose(1, 2),
                                                      rot))


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
        rot = _rotations(x[rows[:, :, None], rows[:, None, :]])
        flat = rows.reshape(-1)
        _rot_rows(x, flat, rot)
        _rot_rows(x.T, flat, rot)                           # two-sided
        _rot_rows(v.T, flat, rot)                           # V <- V G
    d = x.diagonal()
    perm = torch.argsort(d, stable=True)[:n]   # the sentinels sort last
    return d[perm], v[:n, perm]


# ---------------------------------------------------------------------------
# on a process grid
# ---------------------------------------------------------------------------

def block_jacobi_on_grid(a: pm.DistMatrix, block: int = 64, sweeps: int = 0,
                         n_vec: Optional[int] = None) -> pm.ColumnShares:
    """:func:`block_jacobi_eigh` of the grid matrix ``a`` (sentinel on its
    padding), its ``n_vec`` lowest pairs as this rank's column shares.

    The matrix goes from its 2D blocks to **block columns** once: rank r
    holds the m / P tournament pairs ``share(m, P, r)`` (positions of the
    circle method) with both block columns of each, whole, and a run of
    V's rows.  A round: the pair blocks are local, D2 runs on this
    rank's pairs, one ``all_reduce`` of zeroed slots gives every rank all
    m rotations (2 n b words), and then G^T X on this rank's columns, X G
    on its pairs and V G on its rows are local.  The tournament's ring
    shift (block 0 fixed, the rest one place on) moves one block column
    each way between neighbouring ranks (:func:`~eigenkernel_tpu_torch.
    parallel.mesh.swap`, even pairs of ranks first): at most 3
    collectives a round.  At the end the diagonal is gathered and V's
    rows stream past every rank, which keeps its columns.  The matrix is
    padded to a multiple of 2 b P (decoupled sentinels) so that every
    rank holds m / P pairs; b is at most n_m / (2 P)."""
    grid = a.grid
    P, me = grid.size, grid.rank
    n_m, dtype, dev = a.n_m, a.local.dtype, a.local.device
    n_vec = a.n if n_vec is None else int(n_vec)
    b = max(1, min(block, n_m // (2 * P)))
    big = pm.pad_to(n_m, 2 * b * P)
    nb, m = big // b, big // (2 * b)
    if sweeps <= 0:
        sweeps = 12 if dtype == torch.float64 else 8
    pairs = _tournament(nb)                          # (rounds, m, 2)
    n_rounds = pairs.shape[0]
    lo, hi = pm.share(m, P, me)
    w = 2 * (hi - lo) * b                            # this rank's columns
    cuts = [pm.share(m, P, q)[0] for q in range(P)]

    def holders(t):
        """(holder rank, its local slot) of every block in round t."""
        pair = np.empty(nb, np.int64)
        slot = np.empty(nb, np.int64)
        pair[pairs[t].reshape(-1)] = np.repeat(np.arange(m), 2)
        rank = np.searchsorted(cuts, pair, side="right") - 1
        slot[pairs[t].reshape(-1)] = np.tile([0, 1], m)
        return rank, 2 * (pair - np.asarray(cuts)[rank]) + slot

    def columns(t):
        """The global column of each of this rank's columns in round t."""
        blocks = torch.as_tensor(pairs[t, lo:hi].reshape(-1), device=dev)
        return (blocks[:, None] * b + torch.arange(b, device=dev)).reshape(-1)

    # block columns from every rank's 2D block in turn
    x = torch.zeros((big, w), dtype=dtype, device=dev)
    gcol = columns(0)
    nr, nc = a.local.shape
    for q, blk in pm.rank_shares(a.local, grid, [(nr, nc)] * P):
        qr, qc = (q // grid.C) * nr, (q % grid.C) * nc
        hit = (gcol >= qc) & (gcol < qc + nc)
        x[qr:qr + nr, hit] = blk[:, gcol[hit] - qc]
    if big > n_m:
        mu = gershgorin_sentinel(a, grid)
        pad = (gcol >= n_m).nonzero()[:, 0]
        x[gcol[pad], pad] = mu.to(dtype)
    v0, v1 = pm.share(big, P, me)
    v = torch.zeros((v1 - v0, big), dtype=dtype, device=dev)
    v[torch.arange(v1 - v0, device=dev), torch.arange(v0, v1, device=dev)] = 1
    if P > 1:
        pm.make_neighbour_groups(grid)
    rows_tab = torch.as_tensor(_pair_rows(pairs, b), dtype=torch.int64,
                               device=dev)
    lcols = torch.arange(w, device=dev).view(hi - lo, 2 * b)
    total = sweeps * n_rounds
    for it in range(total):
        t = it % n_rounds
        rows = rows_tab[t]                                   # (m, 2b)
        rot = _rotations(x[rows[lo:hi, :, None], lcols[:, None, :]])
        rot_all = pm.gather_slots(rot, slice(lo, hi), (m, 2 * b, 2 * b),
                                  grid)
        flat = rows.reshape(-1)
        _rot_rows(x, flat, rot_all)                          # G^T X
        _rot_rows(x.T, lcols.reshape(-1), rot)               # X G
        _rot_rows(v.T, flat, rot_all)                        # V G
        if it + 1 < total:
            x = _ring_shift(x, holders(t), holders((t + 1) % n_rounds),
                            pairs[(t + 1) % n_rounds, lo:hi].reshape(-1),
                            b, grid)
    gcol = columns((total - 1) % n_rounds)
    d = pm.gather_slots(x[gcol, torch.arange(w, device=dev)], gcol, (big,),
                        grid)
    del x
    # the n_vec lowest (the sentinels sort last), V's rows streamed past
    perm = torch.argsort(d, stable=True)[:n_vec]
    c0, c1 = pm.share(n_vec, P, me)
    out = torch.zeros((n_m, c1 - c0), dtype=dtype, device=dev)
    shapes = [(pm.share(big, P, q)[1] - pm.share(big, P, q)[0], big)
              for q in range(P)]
    for q, vq in pm.rank_shares(v, grid, shapes):
        r0, r1 = pm.share(big, P, q)
        r1 = min(r1, n_m)
        if r1 > r0:
            out[r0:r1] = vq[:r1 - r0, perm[c0:c1]]
    return pm.ColumnShares(d[perm], out, torch.arange(c0, c1, device=dev))


def _ring_shift(x, now, then, blocks, b: int, grid: pm.ProcessGrid):
    """This rank's block columns of the next round: ``blocks`` (the next
    round's block at each slot), from its own columns or a neighbour's.
    ``now`` / ``then``: (holder rank, slot) of every block in this round
    and the next.  Each neighbour sends the blocks it holds now that
    this rank holds next, in block order, the even pairs of ranks first
    (so no chain of waits)."""
    me = grid.rank
    out = torch.empty_like(x)
    mine = [s for s, blk in enumerate(blocks) if now[0][blk] == me]
    for s in mine:
        out[:, s * b:(s + 1) * b] = x[:, now[1][blocks[s]] * b:
                                      (now[1][blocks[s]] + 1) * b]
    first = me + 1 if me % 2 == 0 else me - 1
    for peer in (first, 2 * me - first):
        if not 0 <= peer < grid.size:
            continue
        give = sorted(blk for blk in np.nonzero(now[0] == me)[0]
                      if then[0][blk] == peer)
        take = sorted(blk for blk in blocks if now[0][blk] == peer)
        if len(give) != len(take):
            raise RuntimeError(f"ring shift: rank {me} gives {len(give)} "
                               f"blocks to rank {peer} and takes "
                               f"{len(take)}")
        if not give:
            continue
        got = pm.swap(torch.stack([x[:, now[1][blk] * b:
                                      (now[1][blk] + 1) * b]
                                   for blk in give]), grid, peer)
        for blk, col in zip(take, got):
            s = int(np.nonzero(blocks == blk)[0][0])
            out[:, s * b:(s + 1) * b] = col
    return out
