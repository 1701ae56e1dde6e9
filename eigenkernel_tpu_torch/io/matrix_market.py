"""MatrixMarket file IO: header probe, COO read, write.

Counterpart of ``eigenkernel_tpu/io/matrix_market.py``: coordinate files
go through the native parser (``io/native_mm.py``, ``csrc/mmio.cpp``
built with g++; a failed build raises), ``array`` files through the NumPy
parser ``_read_numpy``, which reads any file and is the plain version the
tests hold the native one against:

* ``read_header``  <- ``mminfo``: probes the header without reading values.
* ``read_matrix``  <- ``read_matrix_file``, including the index-range
  validation of matrix_io.f90:133-135.
* ``write_matrix`` <- ``mmwrite``.

Only the ``real``/``integer``/``pattern`` fields of ``coordinate``/``array``
representations are supported (the real-symmetric scope).
"""

from __future__ import annotations

import io
import time

import numpy as np

from eigenkernel_tpu_torch.core.types import MatrixInfo, SparseMatrix

_VALID_REPS = ("coordinate", "array")
_VALID_FIELDS = ("real", "integer", "pattern", "double")
_VALID_SYMMS = ("general", "symmetric", "skew-symmetric")


class MatrixMarketError(ValueError):
    pass


def _parse_banner(line: str, filename: str) -> tuple[str, str, str]:
    parts = line.strip().lower().split()
    if len(parts) != 5 or parts[0] != "%%matrixmarket" or parts[1] != "matrix":
        raise MatrixMarketError(f"{filename}: invalid MatrixMarket banner: {line!r}")
    rep, field, symm = parts[2], parts[3], parts[4]
    if rep not in _VALID_REPS:
        raise MatrixMarketError(f"{filename}: unsupported representation {rep!r}")
    if field not in _VALID_FIELDS:
        raise MatrixMarketError(f"{filename}: unsupported field {field!r}")
    if symm not in _VALID_SYMMS:
        raise MatrixMarketError(f"{filename}: unsupported symmetry {symm!r}")
    if field == "double":
        field = "real"
    return rep, field, symm


def read_header(filename: str) -> MatrixInfo:
    """Probe a MatrixMarket header (mminfo analog). Cheap: reads a few lines."""
    with open(filename, "r") as f:
        rep, field, symm = _parse_banner(f.readline(), filename)
        line = f.readline()
        while line and (line.startswith("%") or not line.strip()):
            line = f.readline()
        if not line:
            raise MatrixMarketError(f"{filename}: missing size line")
        sizes = line.split()
        if rep == "coordinate":
            rows, cols, entries = int(sizes[0]), int(sizes[1]), int(sizes[2])
        else:
            rows, cols = int(sizes[0]), int(sizes[1])
            entries = rows * cols
    return MatrixInfo(rep=rep, field=field, symm=symm, rows=rows, cols=cols,
                      entries=entries)


def read_matrix(filename: str, info: MatrixInfo | None = None,
                log=None) -> SparseMatrix:
    """Read a full MatrixMarket file into a host-side COO ``SparseMatrix``.

    Square symmetric matrices only.  Indices are validated to be in range.
    The read time goes to ``log`` (an :class:`EventLog`) when one is given.
    """
    t0 = time.time()
    info = info or read_header(filename)
    if info.rows != info.cols:
        raise MatrixMarketError(f"{filename}: matrix is not square "
                                f"({info.rows}x{info.cols})")
    if info.rep == "coordinate":
        from eigenkernel_tpu_torch.io import native_mm

        mat = native_mm.read_coordinate(filename, info)
    else:
        mat = _read_numpy(filename, info)
    if mat.nnz != info.entries:
        raise MatrixMarketError(
            f"{filename}: expected {info.entries} entries, got {mat.nnz}")
    if mat.nnz and (mat.rows.min() < 0 or mat.rows.max() >= info.rows
                    or mat.cols.min() < 0 or mat.cols.max() >= info.cols):
        raise MatrixMarketError(f"{filename}: index out of range")
    if log is not None:
        log.add_event("read_matrix_file", time.time() - t0)
    return mat


def _read_numpy(filename: str, info: MatrixInfo) -> SparseMatrix:
    with open(filename, "r") as f:
        f.readline()  # banner (already validated by read_header)
        line = f.readline()
        while line and (line.startswith("%") or not line.strip()):
            line = f.readline()
        body = f.read()

    if info.rep == "coordinate":
        ncol = 2 if info.field == "pattern" else 3
        data = np.loadtxt(io.StringIO(body), dtype=np.float64, ndmin=2)
        if data.size == 0:
            data = data.reshape(0, ncol)
        rows = data[:, 0].astype(np.int64) - 1
        cols = data[:, 1].astype(np.int64) - 1
        vals = np.ones(rows.shape[0]) if ncol == 2 else data[:, 2].copy()
    else:  # 'array': dense, column-major, full or lower triangle
        vals_all = np.fromiter(body.split(), dtype=np.float64) \
            if body.strip() else np.zeros(0)
        n, m = info.rows, info.cols
        if info.symm == "general":
            if vals_all.size != n * m:
                raise MatrixMarketError(f"{filename}: bad array entry count")
            dense = vals_all.reshape((m, n)).T  # column-major
            rows, cols = np.nonzero(np.ones_like(dense, dtype=bool))
            vals = dense[rows, cols]
        else:
            # lower-triangular packed, column-major
            tri_r, tri_c = np.tril_indices(n)
            order = np.lexsort((tri_r, tri_c))  # column-major packing order
            rows, cols = tri_r[order], tri_c[order]
            if vals_all.size != rows.size:
                raise MatrixMarketError(f"{filename}: bad array entry count")
            vals = vals_all
        info.entries = int(rows.size)

    if info.symm == "skew-symmetric":
        raise MatrixMarketError(f"{filename}: skew-symmetric not supported")
    return SparseMatrix(size=info.rows, rows=rows, cols=cols, values=vals)


def write_matrix(filename: str, mat: SparseMatrix,
                 symm: str = "symmetric") -> None:
    """Write a COO matrix as MatrixMarket coordinate real (mmwrite analog)."""
    with open(filename, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate real {symm}\n")
        f.write(f"{mat.size} {mat.size} {mat.nnz}\n")
        f.writelines(f"{i + 1} {j + 1} {v:.16e}\n"
                     for i, j, v in zip(mat.rows, mat.cols, mat.values))
