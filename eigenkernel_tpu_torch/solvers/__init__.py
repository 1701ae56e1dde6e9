from eigenkernel_tpu_torch.solvers.api import solve
from eigenkernel_tpu_torch.solvers.registry import (
    SOLVERS,
    SolverSpec,
    UnknownSolverError,
    get_spec,
    solver_names,
)

__all__ = [
    "solve",
    "SOLVERS",
    "SolverSpec",
    "UnknownSolverError",
    "get_spec",
    "solver_names",
]
