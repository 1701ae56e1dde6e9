"""The float32 start of ``--dtype mixed scalapack`` and its float64
refinement by Newton step count, on one device.

    python -m eigenkernel_tpu_torch.tools.refine_start [n] [seed] [out.npz]

(from the repository's root: the matrix is ``chip_smoke.py``'s
ELSES-style one, default n = 4096, seed 10).  Runs the float32
``scalapack`` pipeline of whatever ``eigenkernel_tpu_torch`` is on the
path (a copy with another divide-and-conquer tolerance gives another
start), refines its vectors in float64 against the matrix after 6 and 8
Newton steps (``ops/refine.py``), prints each one's residual max
``||A v - lambda v|| / ||A||_F`` and ``max |V^T V - I|``, and with
``out.npz`` saves the start (``v``, ``w``, float32, compressed) for
``tests/refine_compare.py``, which refines it with the JAX package's
function and this one on the CPU.  On the card without ``--platform``;
``EK_PLATFORM=cpu`` runs it on the CPU.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch


def main(argv) -> int:
    n = int(argv[0]) if argv else 4096
    seed = int(argv[1]) if len(argv) > 1 else 10
    out = argv[2] if len(argv) > 2 else None
    sys.path.insert(0, os.getcwd())
    from chip_smoke import elses_like

    from eigenkernel_tpu_torch.core.config import set_matmul_precision_highest
    from eigenkernel_tpu_torch.core.types import SparseMatrix
    from eigenkernel_tpu_torch.ops.refine import refine_eigenpairs
    from eigenkernel_tpu_torch.solvers.api import solve

    set_matmul_precision_highest()
    dev = torch.device(os.environ.get("EK_PLATFORM", "cuda"))
    a = torch.tensor(SparseMatrix(n, *elses_like(n, seed)).to_dense(),
                     device=dev)
    start = solve(a, solver="scalapack", dtype=torch.float32)
    anorm = float(a.norm())
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for steps in (6, 8):
        w, v = refine_eigenpairs(a, start.vectors, steps=steps)
        resid = float(((a @ v - v * w).norm(dim=0) / anorm).max())
        orth = float((v.T @ v - eye).abs().max())
        print(f"n={n} seed={seed} on {name}: {steps} Newton steps, resid "
              f"max {resid:.3e}, |V^T V - I| {orth:.3e}", flush=True)
    if out:
        np.savez_compressed(out, v=start.vectors.cpu().numpy(),
                            w=start.values.cpu().numpy())
        print(f"start saved to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
