"""The native MatrixMarket parser (``csrc/mmio.cpp``) through ctypes.

Counterpart of ``eigenkernel_tpu/io/native_mm.py``'s reader: the source is
the port's own copy, built with ``g++`` by ``ops/build.host_library`` into
``_build/`` at its first use.  A failed build or parse raises: nothing
falls back to the NumPy parser (``matrix_market._read_numpy``, which
reads ``array`` files and stays as the plain version the tests call).
"""

from __future__ import annotations

import ctypes

import numpy as np

from eigenkernel_tpu_torch.core.types import MatrixInfo, SparseMatrix
from eigenkernel_tpu_torch.ops import build

_P = ctypes.POINTER
_ERRORS = {-1: "cannot read the file", -2: "no banner or size line",
           -3: "a malformed entry", -4: "more entries than the header says"}


def _reader():
    fn = build.host_library("mmio.cpp").ek_mm_read_coordinate
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
                   _P(ctypes.c_int64), _P(ctypes.c_int64),
                   _P(ctypes.c_double)]
    return fn


def read_coordinate(filename: str, info: MatrixInfo) -> SparseMatrix:
    """The entries of a coordinate file (0-based indices, float64 values;
    1 for a pattern file), as many as ``info.entries`` says."""
    from eigenkernel_tpu_torch.io.matrix_market import MatrixMarketError

    nnz = info.entries
    rows = np.empty(nnz, dtype=np.int64)
    cols = np.empty(nnz, dtype=np.int64)
    vals = np.empty(nnz, dtype=np.float64)
    got = _reader()(filename.encode(), nnz, int(info.field == "pattern"),
                    rows.ctypes.data_as(_P(ctypes.c_int64)),
                    cols.ctypes.data_as(_P(ctypes.c_int64)),
                    vals.ctypes.data_as(_P(ctypes.c_double)))
    if got < 0:
        raise MatrixMarketError(f"{filename}: {_ERRORS[got]}")
    if got != nnz:
        raise MatrixMarketError(
            f"{filename}: expected {nnz} entries, got {got}")
    return SparseMatrix(size=info.rows, rows=rows, cols=cols, values=vals)
