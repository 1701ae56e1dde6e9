"""EigenKernel on PyTorch and CUDA: the port of ``eigenkernel_tpu``.

The public API is re-exported here, as ``eigenkernel_tpu/__init__.py``
does for the JAX package: the solve and its registry, MatrixMarket IO,
the value types, the verifier, the process grid and the event log.  The
re-exports are lazy, so importing the package imports neither
``torch.distributed`` nor builds a kernel.
"""

from eigenkernel_tpu_torch.version import VERSION

__version__ = VERSION

# name -> the module that defines it
_EXPORTS = {
    "solve": "solvers.api", "fused_solver": "solvers.api",
    "SOLVERS": "solvers.registry", "get_spec": "solvers.registry",
    "solver_names": "solvers.registry",
    "read_header": "io.matrix_market", "read_matrix": "io.matrix_market",
    "write_matrix": "io.matrix_market",
    "EigenPairs": "core.types", "Problem": "core.types",
    "SparseMatrix": "core.types", "MatrixInfo": "core.types",
    "eval_residual_norm": "verify.verifier",
    "eval_orthogonality": "verify.verifier",
    "get_ipratios": "verify.verifier",
    "make_mesh": "parallel.mesh", "layout_grid": "parallel.mesh",
    "EventLog": "obs.events",
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["VERSION", *_EXPORTS]
