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
"""

from __future__ import annotations

import os

import torch

from eigenkernel_tpu_torch.obs import flops as fl
from eigenkernel_tpu_torch.ops import band as bandlib
from eigenkernel_tpu_torch.ops import chase, tridiag as td
from eigenkernel_tpu_torch.ops.backtransform import apply_chase_q_sweeps
from eigenkernel_tpu_torch.ops.bulge import apply_chase_q_blocked
from eigenkernel_tpu_torch.ops.wf_bt import apply_chase_q_wavefront
from eigenkernel_tpu_torch.solvers.pipelines import _run

# EK_BACKTRANSFORM values of the JAX package that are not ported, with
# their ROADMAP items (``blocked`` on a mesh, the JAX package's
# apply_chase_q_blocked_sharded, comes with the mesh paths of slice 7)
_BT_NOT_PORTED = {
    "wavefront": "the XLA wavefront back-transform is not ported: kernel B4 "
                 "(EK_BACKTRANSFORM=wf_pallas) replaces it",
}


def back_transform(band_res: bandlib.BandResult, chase_res, z: torch.Tensor,
                   block: int) -> torch.Tensor:
    """``Q_band (Q_chase z)``."""
    method = os.environ.get("EK_BACKTRANSFORM", "auto")
    if method in ("auto", "wf_pallas"):
        z = apply_chase_q_wavefront(chase_res, z)
    elif method == "pallas":
        z = apply_chase_q_sweeps(chase_res, z)
    elif method == "blocked":
        z = apply_chase_q_blocked(chase_res, z,
                                  int(os.environ.get("EK_BT_GROUP", "0")))
    else:
        raise NotImplementedError(_BT_NOT_PORTED.get(
            method, f"EK_BACKTRANSFORM={method!r}: not a back-transform of "
                    f"this package (auto, wf_pallas, pallas, blocked)"))
    return bandlib.apply_band_q(band_res, z, block)


def sep_two_stage(ctx, a: torch.Tensor, n_vec: int):
    """full -> band -> tridiagonal, tridiagonal solve, back-transform."""
    n = a.shape[0]
    bw = int(os.environ.get("EK_TWOSTAGE_BW", "0")) or ctx.block_size
    band_res = _run(ctx, "sep:full_to_band", bandlib.to_band, a, bw,
                    flops=fl.full_to_band(n, bw))
    chase_res = _run(ctx, "sep:band_to_tridiag", chase.band_to_tridiag,
                     band_res.band, bw, flops=fl.band_to_tridiag(n, bw))
    # the dense band matrix is dead once the chase has read it: drop it
    # before the eigenvector stages
    band_res = band_res._replace(band=None)
    w, z = _run(ctx, "sep:tridiag_eigh", td.tridiag_eigh, chase_res.d,
                chase_res.e, n_vec, flops=fl.tridiag_eigh(n, n_vec))
    z = _run(ctx, "sep:back_transform", back_transform, band_res, chase_res,
             z, bw, flops=fl.back_transform_two_stage(n, n_vec))
    return w, z
