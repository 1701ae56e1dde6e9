"""State handed between the two packages as numpy arrays.

An eigensolver has no weights; its state between stages is the
generalized reduction ``(A_std, factor, style)``, the tridiagonal
reduction ``(d, e, V, taus)``, the two-stage core's band reduction
``(band, V, taus)`` and chase ``(d, e, HV, HT)``, and the eigenpairs.
These functions let a test run one package's stage N and the other's
stage N+1 on the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from eigenkernel_tpu_torch.core.types import EigenPairs
from eigenkernel_tpu_torch.ops.band import BandResult
from eigenkernel_tpu_torch.ops.bulge import ChaseResult
from eigenkernel_tpu_torch.ops.householder import TridiagResult
from eigenkernel_tpu_torch.ops.reduction import Reduction


def _put(x, device, dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(x), device=device, dtype=dtype)


def reduction_from_numpy(a_std, factor, style, device, dtype) -> Reduction:
    """A :class:`Reduction` from numpy arrays (the JAX package's
    ``Reduction``: ``A_std`` and L for the scalapack styles, R = L^{-1}
    for the elpa style)."""
    return Reduction(_put(a_std, device, dtype), _put(factor, device, dtype),
                     str(style))


def tridiag_from_numpy(d, e, V, taus, device, dtype) -> TridiagResult:
    """A :class:`TridiagResult` on ``device`` from numpy arrays (e.g. the
    fields of the JAX package's ``TridiagResult``)."""
    return TridiagResult(*(_put(x, device, dtype) for x in (d, e, V, taus)))


def band_from_numpy(band, V, taus, bw, device, dtype) -> BandResult:
    """A :class:`BandResult` from numpy arrays (the fields of the JAX
    package's ``BandResult``; the layouts are the same)."""
    return BandResult(*(_put(x, device, dtype) for x in (band, V, taus)),
                      bw=int(bw))


def chase_from_numpy(d, e, HV, HT, bw, device, dtype) -> ChaseResult:
    """A :class:`ChaseResult` from numpy arrays (the fields of the JAX
    package's ``ChaseResult``: the same (n, T, bw) / (n, T) stores)."""
    return ChaseResult(*(_put(x, device, dtype) for x in (d, e, HV, HT)),
                       bw=int(bw))


def eigenpairs_to_numpy(pairs: EigenPairs) -> tuple[np.ndarray, np.ndarray]:
    """``(values, vectors)`` as host numpy arrays."""
    return pairs.values.cpu().numpy(), pairs.vectors.cpu().numpy()
