"""An ELSES-style tight-binding Hamiltonian.

A frozen copy of ``chip_smoke.py::elses_like``: a band of half-width
``band`` whose hoppings decay as e^(-offset / ``decay``) (a unit normal
diagonal), plus ``long_frac`` of the remaining lower-triangle pairs as
weak long-range couplings of scale ``long_scale``.
"""

from __future__ import annotations

import numpy as np


def coo(n: int, rng: np.random.Generator, params: dict, made: dict):
    band = int(params.get("band", 64))
    decay = float(params.get("decay", 16.0))
    long_frac = float(params.get("long_frac", 0.01))
    long_scale = float(params.get("long_scale", 0.05))
    rows, cols, vals = [], [], []
    for off in range(min(band, n - 1) + 1):
        i = np.arange(off, n)
        rows.append(i)
        cols.append(i - off)
        scale = 1.0 if off == 0 else np.exp(-off / decay)
        vals.append(rng.standard_normal(i.size) * scale)
    if n > band + 1:
        n_pairs = (n - band - 1) * (n - band) // 2
        m = int(long_frac * n_pairs)
        i = rng.integers(band + 1, n, size=m)
        j = (rng.random(m) * (i - band)).astype(np.int64)   # j < i - band
        key = np.unique(i * n + j)
        rows.append(key // n)
        cols.append(key % n)
        vals.append(rng.standard_normal(key.size) * long_scale)
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)
