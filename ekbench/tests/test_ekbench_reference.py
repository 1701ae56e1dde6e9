"""The plain reference agrees with SciPy on a tiny pencil, and its
numbers tell a right solve from a wrong one."""

import numpy as np
import pytest
import scipy.linalg
import torch

from ekbench import data, reference
from ekbench.tests.tiny import TINY, TINY_GEN


@pytest.mark.parametrize("cfg", [TINY, TINY_GEN], ids=["standard", "pencil"])
def test_eigenvalues_match_scipy(cfg):
    m = data.make(cfg, 5, "cpu")
    a = m["a"].numpy()
    b = m["b"].numpy() if "b" in m else None
    want = scipy.linalg.eigh(a, b, eigvals_only=True)
    got = reference.eigenvalues(m["a"], m.get("b")).numpy()
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()


def _solve(m):
    a = m["a"].numpy()
    b = m["b"].numpy() if "b" in m else None
    w, v = scipy.linalg.eigh(a, b)
    return torch.from_numpy(w), torch.from_numpy(v)


@pytest.mark.parametrize("cfg", [TINY, TINY_GEN], ids=["standard", "pencil"])
def test_judge_reads_small_for_exact_pairs_and_large_for_wrong_ones(cfg):
    m = data.make(cfg, 6, "cpu")
    ref = reference.eigenvalues(m["a"], m.get("b"))
    w, v = _solve(m)
    idx = torch.tensor([0, 5, w.numel() - 1])
    k = w.numel()
    ok = reference.judge(m["a"], m.get("b"), ref, k, [w, w], [v[:, idx]],
                         idx, w, v)
    assert max(ok["eig_err"], ok["residual"], ok["orth"]) < 1e-12
    assert len(ok["per_solve"]) == 2
    bad_v = v.clone()
    bad_v[:, 3] = bad_v[:, 4]               # a repeated vector
    bad = reference.judge(m["a"], m.get("b"), ref, k, [w], [], idx, w,
                          bad_v)
    assert bad["orth"] > 0.5 and bad["residual"] > 1e-3
    w2 = w.clone()
    w2[7] += 1e-6 * float(w.abs().max())
    bad = reference.judge(m["a"], m.get("b"), ref, k, [w2, w],
                          [v[:, idx]], idx, w, v)
    assert bad["per_solve"][0][0] > 5e-7 and bad["per_solve"][1][0] < 1e-12


@pytest.mark.parametrize("cut", ["value", "pairs"])
def test_judge_reads_a_wrong_shape_as_wrong(cut):
    m = data.make(TINY, 6, "cpu")
    ref = reference.eigenvalues(m["a"])
    w, v = _solve(m)
    k = w.numel()
    if cut == "value":
        out = reference.judge(m["a"], None, ref, k, [w[:-1]], [],
                              torch.tensor([0]), w, v)
    else:      # half the pairs, each of them right
        h = k // 2
        out = reference.judge(m["a"], None, ref, k, [w[:h]], [],
                              torch.tensor([0]), w[:h], v[:, :h])
    assert out["eig_err"] == reference.WRONG
