"""The check fails the control and the faults it has to catch, at a size
a test run holds (on the chip the same runs are made at each cell's own
size: ``ekbench/control.py``).

* the control: the port's own float32 path in a float64 cell;
* an answer altered where it is produced (an eigenvalue, an
  eigenvector entry);
* a step that returns its state unchanged (the back-transform);
* half of the batch left out (half the eigenpairs, the others copies
  of them, or missing).
"""

import time

import pytest
import torch

from ekbench import control, harness
from ekbench.tests.tiny import E2E, cell
from eigenkernel_tpu_torch.core.types import EigenPairs
from eigenkernel_tpu_torch.ops import householder
from eigenkernel_tpu_torch.solvers import api, twostage

WORKLOADS = ["vcnt22500_gen.elpa2_full", "vcnt22500.eigensx_full",
             "vcnt22500_gen.select_low500"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_comes_out_not_correct(workload):
    c, cfg = cell(workload)
    low = control.readings(c, cfg, [11, 12], "float64", "cpu")
    ctl = control.readings(c, cfg, [11, 12, 13], "float32", "cpu")
    assert all(r["correct"] for r in low)
    assert not any(r["correct"] for r in ctl)


def _run(workload):
    c, cfg = cell(workload)
    return harness.run_cell(c, cfg, 5, 0.0, False, "cpu", E2E, {},
                            time.perf_counter(), warm=False)


def _wrap(monkeypatch, change):
    solve = api.solve

    def broken(*args, **kwargs):
        out = solve(*args, **kwargs)
        return EigenPairs(*change(out.values.clone(), out.vectors.clone()))

    monkeypatch.setattr(api, "solve", broken)


def _value(w, v):
    w[len(w) // 2] += 1e-7 * float(w.abs().max())
    return w, v


def _vector(w, v):
    v[3, len(w) // 3] += 1e-6
    return w, v


def _half(w, v):
    h = (len(w) + 1) // 2
    return torch.cat([w[:h], w[:len(w) - h]]), torch.cat(
        [v[:, :h], v[:, :len(w) - h]], dim=1)


def _first_half(w, v):
    h = len(w) // 2
    return w[:h], v[:, :h]


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("fault", [_value, _vector, _half, _first_half],
                         ids=["value", "vector", "half", "first_half"])
def test_a_fault_in_the_answer_comes_out_not_correct(workload, fault,
                                                      monkeypatch):
    assert _run(workload)["correct"]
    _wrap(monkeypatch, fault)
    assert not _run(workload)["correct"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_skipped_back_transform_comes_out_not_correct(workload,
                                                        monkeypatch):
    monkeypatch.setattr(twostage, "back_transform",
                        lambda band, chase, z, *a, **k: z)
    monkeypatch.setattr(householder, "apply_q", lambda tri, z, *a, **k: z)
    assert not _run(workload)["correct"]
