"""Core value types: matrix headers, host-side COO matrices, eigenpairs.

Counterpart of ``eigenkernel_tpu/core/types.py``:

* ``MatrixInfo``   <- ``ek_matrix_info_t``  (MatrixMarket header)
* ``SparseMatrix`` <- ``ek_sparse_mat_t``   (host COO, numpy, 0-based)
* ``EigenPairs``   <- ``ek_eigenpairs_types_union_t``, holding torch tensors:
  ``vectors[:, j]`` is the eigenvector of ``values[j]`` (ascending).
* ``Problem``      <- a standard (B None) or generalized (B SPD) problem of
  host COO matrices.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np


@dataclass
class MatrixInfo:
    """MatrixMarket header: representation/field/symmetry + dimensions."""

    rep: str = "coordinate"  # 'coordinate' | 'array'
    field: str = "real"      # 'real' | 'integer' | 'pattern'
    symm: str = "symmetric"  # 'general' | 'symmetric' | 'skew-symmetric'
    rows: int = 0
    cols: int = 0
    entries: int = 0


@dataclass
class SparseMatrix:
    """Host-side COO matrix as read from a MatrixMarket file.

    Stores only the entries present in the file (lower triangle for
    symmetric files); ``to_dense`` fills both triangles.
    """

    size: int
    rows: np.ndarray    # int64[nnz], 0-based
    cols: np.ndarray    # int64[nnz], 0-based
    values: np.ndarray  # float64[nnz]

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    def to_dense(self, dtype=np.float64) -> np.ndarray:
        """Dense symmetric matrix with both triangles filled."""
        n = self.size
        a = np.zeros((n, n), dtype=dtype)
        a[self.rows, self.cols] = self.values.astype(dtype)
        off = self.rows != self.cols
        a[self.cols[off], self.rows[off]] = self.values[off].astype(dtype)
        return a


@dataclass
class EigenPairs:
    """Result of an eigensolve: ``values`` ascending, ``vectors[:, j]``.

    ``values`` (n_vec,) and ``vectors`` (n, n_vec) are torch tensors on the
    solve's device.  ``n_vec`` may be smaller than the matrix dimension for
    selecting solvers.  From a solve on a process grid (``grid``),
    ``values`` is whole on every rank and ``vectors`` holds this rank's
    columns, whole, at the places ``cols`` (int64) of ``values``.
    """

    values: Any
    vectors: Any
    meta: dict = field(default_factory=dict)
    grid: Any = None
    cols: Any = None

    @property
    def dim(self) -> int:
        return int(self.vectors.shape[0])


@dataclass
class Problem:
    """An eigenproblem: standard (B is None) or generalized (B SPD)."""

    A: SparseMatrix
    B: Optional[SparseMatrix] = None

    @property
    def is_generalized(self) -> bool:
        return self.B is not None

    @property
    def dim(self) -> int:
        return self.A.size
