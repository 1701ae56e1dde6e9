"""The JAX package's ``refine_eigenpairs`` (its float64 GEMM branch, on
the CPU) and the port's on one float32 start, by Newton step count.

    JAX_PLATFORMS=cpu python tests/refine_compare.py start.npz [n] [seed]

from the repository's root.  ``start.npz`` is a start saved by
``python -m eigenkernel_tpu_torch.tools.refine_start``; the matrix is
``chip_smoke.py``'s ELSES-style one of that n and seed (default 4096,
10).  Prints each refiner's residual max ``||A v - lambda v|| / ||A||_F``
and ``max |V^T V - I|`` after 6 and 8 steps (``EK_REFINE_STEPS``).  Not a
test: it runs for minutes at n = 4096.
"""

import os
import sys

import numpy as np


def main(argv) -> int:
    path = argv[0]
    n = int(argv[1]) if len(argv) > 1 else 4096
    seed = int(argv[2]) if len(argv) > 2 else 10
    sys.path.insert(0, os.getcwd())
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    from chip_smoke import elses_like
    from eigenkernel_tpu.ops.refine import refine_eigenpairs as jax_refine
    from eigenkernel_tpu_torch.core.types import SparseMatrix
    from eigenkernel_tpu_torch.ops.refine import refine_eigenpairs

    a = SparseMatrix(n, *elses_like(n, seed)).to_dense()
    v32 = np.load(path)["v"]
    anorm = np.linalg.norm(a)

    def report(who, steps, w, v):
        w, v = np.asarray(w, np.float64), np.asarray(v, np.float64)
        resid = np.linalg.norm(a @ v - v * w, axis=0).max() / anorm
        orth = np.abs(v.T @ v - np.eye(v.shape[1])).max()
        print(f"{who} {steps} Newton steps: resid max {resid:.3e}, "
              f"|V^T V - I| {orth:.3e}", flush=True)

    for steps in (6, 8):
        w, v = refine_eigenpairs(torch.tensor(a), torch.tensor(v32),
                                 steps=steps)
        report("port", steps, w.numpy(), v.numpy())
        w, v = jax.jit(lambda a_, v_: jax_refine(a_, v_, steps=steps))(
            jnp.asarray(a), jnp.asarray(v32))
        report("jax ", steps, w, v)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
