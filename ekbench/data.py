"""Cells, configurations and their matrices, found by name from files.

A cell is ``cells/<name>.json`` (its ``config``, ``solver``, ``n_vec``,
``dtype``, ``env`` and ``limits``); a configuration is
``configs/<name>.json`` (``n`` and its ``matrices``, each a generator of
``gen/`` with its parameters, made in the file's order).  The matrices
come from ``--seed`` alone: role i of a configuration draws from
``numpy.random.default_rng([seed mod 2^64, i])``.
"""

from __future__ import annotations

import importlib
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load(kind: str, name: str) -> dict:
    path = os.path.join(HERE, kind, f"{name}.json")
    with open(path) as f:
        return json.load(f)


def cell(name: str) -> dict:
    return _load("cells", name)


def config(name: str) -> dict:
    return _load("configs", name)


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def rng(seed: int, role: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), role])


def make_coo(cfg: dict, seed: int) -> dict:
    """{role: (rows, cols, vals)} of the configuration's matrices."""
    made = {}
    for i, (role, params) in enumerate(cfg["matrices"].items()):
        gen = importlib.import_module(f"ekbench.gen.{params['gen']}")
        made[role] = gen.coo(int(cfg["n"]), rng(seed, i), params, made)
    return made


def densify(n: int, coo, device, dtype):
    """The dense symmetric matrix of a lower-triangle COO, on ``device``."""
    import torch

    rows, cols, vals = coo
    m = torch.zeros((n, n), dtype=dtype, device=device)
    r = torch.as_tensor(rows, device=device)
    c = torch.as_tensor(cols, device=device)
    v = torch.as_tensor(vals, device=device, dtype=dtype)
    m[r, c] = v
    m[c, r] = v
    return m


def make(cfg: dict, seed: int, device) -> dict:
    """{role: dense float64 tensor on ``device``}."""
    import torch

    n = int(cfg["n"])
    return {role: densify(n, coo, device, torch.float64)
            for role, coo in make_coo(cfg, seed).items()}
