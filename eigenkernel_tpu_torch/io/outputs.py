"""Output writers: eigenvalues.dat, ipratios.dat, eigenvector files, log.json.

Counterpart of ``eigenkernel_tpu/io/outputs.py``:

* ``write_eigenvalues`` / ``write_ipratios`` <- main.f90:111-143: one
  ``index value`` line per entry, 1-based, E26.16-style floats;
  ``read_indexed_values`` reads such a file back.
* ``print_eigenvectors`` <- matrix_io.f90:173-285: one file
  ``<dir>/%08d.dat`` per requested vector, text lines ``i j value`` or
  (``--binary``) one Fortran unformatted sequential record: 4-byte
  little-endian length marker, float64 payload, trailing marker.
* ``write_log_json`` <- main.f90:185-190: ``{"setting": {...},
  "events": [{name, num_repeated, val}, ...]}``.

Under several processes the caller writes eigenvalues.dat, ipratios.dat
and log.json on process 0 only; ``print_eigenvectors`` is called on every
process and each writes the files of the vectors it holds.
"""

from __future__ import annotations

import json
import os
from typing import Iterable

import numpy as np

from eigenkernel_tpu_torch.core.types import EigenPairs
from eigenkernel_tpu_torch.obs.events import EventLog


def _fmt(value: float) -> str:
    return f"{value:26.16E}"


def _write_indexed(path: str, values) -> None:
    vals = np.asarray(values, dtype=np.float64)
    with open(path, "w") as f:
        f.writelines(f"{j:8d} {_fmt(v)}\n"
                     for j, v in enumerate(vals.tolist(), start=1))


def read_indexed_values(path: str) -> np.ndarray:
    """The values of an ``index value`` file (eigenvalues.dat,
    ipratios.dat, and the reference's ground-truth ``*_ev.txt`` files)."""
    return np.loadtxt(path, ndmin=2)[:, 1]


def write_eigenvalues(path: str, values) -> None:
    _write_indexed(path, values)


def write_ipratios(path: str, ipratios) -> None:
    _write_indexed(path, ipratios)


def print_eigenvectors(eigenpairs: EigenPairs, out_dir: str,
                       ranges: Iterable[tuple[int, int]],
                       binary: bool = False) -> None:
    """Write eigenvectors for 1-based index ranges, one file per vector.

    Only the requested columns are copied from the device, one range at a
    time.  From a grid solve (``eigenpairs.grid``, called on every rank)
    each rank writes the files of the range's vectors it holds, all ranks
    at once and nothing gathered: the owner-parallel writing of the JAX
    package's ``outputs.py:62-110``, with the vectors' owners the ranks
    that hold their columns.
    """
    os.makedirs(out_dir, exist_ok=True)
    n = eigenpairs.dim
    for lo, hi in ranges:
        if lo < 1:  # 1-based indices; j=0 would alias the last column
            raise ValueError(f"eigenvector index {lo} is not 1-based")
        if eigenpairs.grid is None:
            block = eigenpairs.vectors[:, lo - 1:hi]
            js = range(lo, hi + 1)
        else:
            cols = eigenpairs.cols
            mine = (cols >= lo - 1) & (cols < hi)
            block = eigenpairs.vectors[:, mine]
            js = (cols[mine] + 1).tolist()
        block = block.double().cpu().numpy()
        for c, j in enumerate(js):
            col = block[:, c]
            path = os.path.join(out_dir, f"{j:08d}.dat")
            if binary:
                payload = col.astype("<f8").tobytes()
                marker = np.int32(len(payload)).astype("<i4").tobytes()
                with open(path, "wb") as f:
                    f.write(marker + payload + marker)
            else:
                with open(path, "w") as f:
                    f.writelines(f"{i + 1:8d} {j:8d} {_fmt(col[i])}\n"
                                 for i in range(n))


def write_log_json(path: str, setting: dict, log: EventLog) -> None:
    with open(path, "w") as f:
        json.dump({"setting": setting, "events": log.events()}, f, indent=2)
        f.write("\n")
