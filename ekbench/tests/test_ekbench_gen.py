"""The generators give the same matrices for a seed and others for
another seed, at any whole seed."""

import numpy as np
import pytest
import torch

from ekbench import data
from ekbench.tests.tiny import TINY_GEN


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, 3 * 2 ** 40, -5])
def test_same_seed_same_matrices(seed):
    one = data.make(TINY_GEN, seed, "cpu")
    two = data.make(TINY_GEN, seed, "cpu")
    for role in ("a", "b"):
        assert torch.equal(one[role], two[role])


def test_other_seed_other_matrices():
    one = data.make(TINY_GEN, 1, "cpu")
    two = data.make(TINY_GEN, 2, "cpu")
    assert not torch.equal(one["a"], two["a"])
    assert not torch.equal(one["b"], two["b"])


def test_matrices_are_symmetric_and_b_is_spd():
    m = data.make(TINY_GEN, 3, "cpu")
    assert torch.equal(m["a"], m["a"].T) and torch.equal(m["b"], m["b"].T)
    assert float(torch.linalg.eigvalsh(m["b"]).min()) > 0
    # B has A's sparsity
    assert torch.equal(m["a"] != 0, m["b"] != 0)


def test_elses_like_shape_at_full_width():
    from ekbench.gen import elses_like

    rows, cols, vals = elses_like.coo(
        1000, np.random.default_rng(0),
        {"band": 64, "decay": 16.0, "long_frac": 0.01}, {})
    assert (rows >= cols).all() and np.isfinite(vals).all()
    off = rows - cols
    long = off > 64
    assert long.any() and np.abs(vals[long]).max() < 0.05 * 6
    # every band entry present once, no duplicate position
    assert np.unique(rows * 1000 + cols).size == rows.size
    assert (off <= 64).sum() == sum(1000 - k for k in range(65))
