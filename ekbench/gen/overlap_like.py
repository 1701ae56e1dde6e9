"""An SPD overlap matrix with the sparsity of another matrix.

A frozen copy of ``chip_smoke.py::overlap_like``: on the pattern of the
matrix made under the role ``pattern``, off-diagonal entries
``scale`` e^(-|i - j| / ``decay``) N(0, 1); each diagonal entry is 1 plus
the sum of its row's off-diagonal magnitudes, so B is strictly
diagonally dominant (cond ~ 10 at the defaults).
"""

from __future__ import annotations

import numpy as np


def coo(n: int, rng: np.random.Generator, params: dict, made: dict):
    rows, cols, _ = made[params.get("pattern", "a")]
    scale = float(params.get("scale", 0.2))
    decay = float(params.get("decay", 16.0))
    off = rows != cols
    vals = np.where(off, scale * np.exp(-np.abs(rows - cols) / decay)
                    * rng.standard_normal(rows.size), 0.0)
    rowsum = np.zeros(n)
    np.add.at(rowsum, rows[off], np.abs(vals[off]))
    np.add.at(rowsum, cols[off], np.abs(vals[off]))
    vals[~off] = 1.0 + rowsum[rows[~off]]
    return rows, cols, vals
