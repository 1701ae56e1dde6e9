"""State handed between the two packages as numpy arrays.

An eigensolver has no weights; its state between stages is the
tridiagonal reduction ``(d, e, V, taus)`` and the eigenpairs.  These two
functions let a test run one package's stage N and the other's stage N+1
on the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from eigenkernel_tpu_torch.core.types import EigenPairs
from eigenkernel_tpu_torch.ops.householder import TridiagResult


def tridiag_from_numpy(d, e, V, taus, device, dtype) -> TridiagResult:
    """A :class:`TridiagResult` on ``device`` from numpy arrays (e.g. the
    fields of the JAX package's ``TridiagResult``)."""
    def put(x):
        return torch.tensor(np.asarray(x), device=device, dtype=dtype)

    return TridiagResult(d=put(d), e=put(e), V=put(V), taus=put(taus))


def eigenpairs_to_numpy(pairs: EigenPairs) -> tuple[np.ndarray, np.ndarray]:
    """``(values, vectors)`` as host numpy arrays."""
    return pairs.values.cpu().numpy(), pairs.vectors.cpu().numpy()
