"""Two-stage SEP core: full -> band -> tridiagonal (eigen_sx / ELPA2 analog).

Counterpart of ``eigenkernel_tpu/solvers/twostage.py``:

* stage 1, ``sep:full_to_band``: :func:`.ops.band.to_band` (GEMMs);
* stage 2, ``sep:band_to_tridiag``: the bulge chase, kernel B3
  (:func:`.ops.chase.band_to_tridiag`);
* ``sep:tridiag_eigh``: the tridiagonal solver of the one-stage core;
* ``sep:back_transform``: ``z_A = Q_band (Q_chase z_T)``, the chase part by
  kernel B4 (``EK_BACKTRANSFORM`` = ``auto`` | ``wf_pallas``, the default),
  B5 (``pallas``) or the WY-grouped PyTorch loop ``blocked`` (its group
  ``EK_BT_GROUP``, 0 for 32, as in the JAX package), the band part by WY
  GEMMs.

The bandwidth is ``EK_TWOSTAGE_BW``, else the panel width: the JAX
package's rule off the TPU (its TPU pick of 32 and the ``n % bw`` fix-up do
not apply, since every op here takes any n).

On a process grid (``ctx.mesh``, JAX ``solvers/twostage.py:73-165``) the
matrix is a :class:`~eigenkernel_tpu_torch.parallel.mesh.DistMatrix`:
``to_band`` runs on its blocks and hands on the band's banded lower
storage, O(n bw) on every rank; every rank runs the chase (B3) on it, as
the JAX package does (``twostage.py:25-32``), in ``EK_CHASE_CHUNKS``
sweep ranges (default 4 on a grid, 1 on one device, JAX
``twostage.py:112-121``), and the grid's ``tridiag_eigh`` gives each rank
its columns.  The back-transform works on those columns, whole rows:
``EK_BACKTRANSFORM=auto`` and ``blocked`` keep each rank's WY groups of
each finished range of the chase store (so a rank holds one range in
flight and n^2/P words at rest, never the whole store) and broadcast them
in turn (``bulge.apply_chase_q_blocked_sharded``; "Meshes keep the sharded
blocked schedule", ``twostage.py:138-146``); ``wf_pallas`` and ``pallas``
keep the store whole on every rank and run B4 or B5 on the rank's
columns, as the JAX package replicates for them (``twostage.py:44-50``).
The band part broadcasts the stage-1 WY groups in turn.
"""

from __future__ import annotations

import os

import torch

from eigenkernel_tpu_torch.obs import flops as fl
from eigenkernel_tpu_torch.ops import band as bandlib
from eigenkernel_tpu_torch.ops import chase, tridiag as td, wf_bt
from eigenkernel_tpu_torch.ops.backtransform import apply_chase_q_sweeps
from eigenkernel_tpu_torch.ops.bulge import (GridChaseStore, _group_size,
                                             apply_chase_q_blocked,
                                             apply_chase_q_blocked_sharded,
                                             keep_own_groups,
                                             n_chase_groups)
from eigenkernel_tpu_torch.ops.wf_bt import apply_chase_q_wavefront
from eigenkernel_tpu_torch.solvers.pipelines import _run, tridiag_eigh

# EK_BACKTRANSFORM values of the JAX package that are not ported
_BT_NOT_PORTED = {
    "wavefront": "the XLA wavefront back-transform is not ported: kernel B4 "
                 "(EK_BACKTRANSFORM=wf_pallas) replaces it",
}


def bt_method(mesh=None) -> str:
    """``EK_BACKTRANSFORM``, ``auto`` resolved: B4 on one device, the
    sharded blocked schedule on a grid."""
    method = os.environ.get("EK_BACKTRANSFORM", "auto")
    if method == "auto":
        return "wf_pallas" if mesh is None else "blocked"
    if method not in ("wf_pallas", "pallas", "blocked"):
        raise NotImplementedError(_BT_NOT_PORTED.get(
            method, f"EK_BACKTRANSFORM={method!r}: not a back-transform of "
                    f"this package (auto, wf_pallas, pallas, blocked)"))
    return method


def _bt_group() -> int:
    return int(os.environ.get("EK_BT_GROUP", "0"))


def chase_chunks(mesh=None) -> int:
    """``EK_CHASE_CHUNKS``: the chase's sweep ranges, 4 on a grid and 1 on
    one device by default (JAX ``twostage.py:112-113``)."""
    return int(os.environ.get("EK_CHASE_CHUNKS",
                              "4" if mesh is not None else "1"))


def back_transform(band_res: bandlib.BandResult, chase_res, z: torch.Tensor,
                   block: int, mesh=None, method: str = "") -> torch.Tensor:
    """``Q_band (Q_chase z)``; on a grid ``z`` is a rank's own columns."""
    method = method or bt_method(mesh)
    if method == "wf_pallas":
        # every rank builds the whole P stream (it does not depend on the
        # columns), in phases of at most n^2 / P words: more phases of
        # the same launches
        z = apply_chase_q_wavefront(
            chase_res, z, stream_bytes=0 if mesh is None
            else wf_bt.grid_stream_bytes(z.shape[0], z.element_size(),
                                         mesh.size))
    elif method == "pallas":
        z = apply_chase_q_sweeps(chase_res, z)
    elif mesh is not None:
        z = apply_chase_q_blocked_sharded(chase_res, z, mesh)
    else:
        z = apply_chase_q_blocked(chase_res, z, _bt_group())
    return bandlib.apply_band_q(band_res, z, block, mesh)


def chase_on_grid(lower: torch.Tensor, n: int, bw: int, mesh, method: str):
    """B3 on this rank's copy of the banded state, in
    :func:`chase_chunks` sweep ranges; under the blocked schedule only
    this rank's WY groups of each finished range are kept (the result's
    HV a :class:`~.ops.bulge.GridChaseStore`), else the store is whole."""
    chunks, group = chase_chunks(mesh), _bt_group()
    if method != "blocked":
        return chase.band_to_tridiag_chunked(lower, n, bw, chunks,
                                             group=group)
    g = _group_size(group, max(bw, 1))
    store = GridChaseStore(g, n_chase_groups(n, g), chase.n_positions(n, bw),
                           max(bw, 1), {})
    res = chase.band_to_tridiag_chunked(lower, n, bw, chunks,
                                        keep_own_groups(store, n, mesh),
                                        group)
    return res._replace(HV=store)


def sep_two_stage(ctx, a, n_vec: int):
    """full -> band -> tridiagonal, tridiagonal solve, back-transform.  On
    a grid ``a`` is a DistMatrix and the result a ColumnShares."""
    bw = int(os.environ.get("EK_TWOSTAGE_BW", "0")) or ctx.block_size
    if ctx.mesh is not None:
        return _sep_two_stage_grid(ctx, a, n_vec, bw)
    n = a.shape[0]
    method = bt_method()
    band_res = _run(ctx, "sep:full_to_band", bandlib.to_band, a, bw,
                    flops=fl.full_to_band(n, bw))
    chase_res = _run(ctx, "sep:band_to_tridiag", chase.band_to_tridiag,
                     band_res.band, bw, chase_chunks(),
                     flops=fl.band_to_tridiag(n, bw))
    # the dense band matrix is dead once the chase has read it: drop it
    # before the eigenvector stages
    band_res = band_res._replace(band=None)
    w, z = _run(ctx, "sep:tridiag_eigh", td.tridiag_eigh, chase_res.d,
                chase_res.e, n_vec, flops=fl.tridiag_eigh(n, n_vec))
    z = _run(ctx, "sep:back_transform", back_transform, band_res, chase_res,
             z, bw, None, method, flops=fl.back_transform_two_stage(n, n_vec))
    return w, z


def _sep_two_stage_grid(ctx, a, n_vec: int, bw: int):
    mesh = ctx.mesh
    n = a.n_m
    method = bt_method(mesh)
    band_res = _run(ctx, "sep:full_to_band", bandlib.to_band, a, bw, mesh,
                    flops=fl.full_to_band(n, bw))
    chase_res = _run(ctx, "sep:band_to_tridiag", chase_on_grid,
                     band_res.lower, n, bw, mesh, method,
                     flops=fl.band_to_tridiag(n, bw))
    band_res = band_res._replace(lower=None)
    out = _run(ctx, "sep:tridiag_eigh", tridiag_eigh, chase_res.d,
               chase_res.e, n_vec, mesh, a.n,
               flops=fl.tridiag_eigh(n, n_vec))
    z = _run(ctx, "sep:back_transform", back_transform, band_res, chase_res,
             out.vectors, bw, mesh, method,
             flops=fl.back_transform_two_stage(n, n_vec))
    return out._replace(vectors=z)
