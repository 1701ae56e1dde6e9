"""The solver registry: ``-s <name>`` -> pipeline combination.

A copy of ``eigenkernel_tpu/solvers/registry.py``: the same 20 names and
specs, so CLI invocations and ``log.json`` files are comparable between
the two packages; every name runs in this package.  ``resolve_auto``'s
TPU branches never fire here (the backend is ``cuda`` or ``cpu``), so
``auto`` resolves to the one-stage core.

  name                          reduction    SEP core    paper tag
  ----------------------------- ----------- ----------- ---------
  lapack                         —           eigh (1dev)
  scalapack                      —           one_stage
  scalapack_select               —           one_stage (partial)
  eigensx                        —           two_stage
  general_scalapack              scalapack   one_stage    'A'
  general_scalapack_select       scalapack   one_stage (partial)
  general_scalapacknew_eigens    scalapack   one_stage
  general_scalapack_eigensx      scalapack   two_stage    'B'
  general_scalapack_eigens       scalapack   one_stage
  general_elpa_scalapack         elpa        one_stage    'C'
  general_elpa1                  elpa        one_stage    'E'
  general_elpa2                  elpa        two_stage    'D'
  general_elpa_eigensx           elpa        two_stage    'G'
  general_elpa_eigens            elpa        one_stage    'F'
  eigh / general_eigh            (elpa)      eigh        extras
  jacobi / general_jacobi        (elpa)      jacobi      extras
  qdwh_dc / general_qdwh_dc      (elpa)      qdwh        extras
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class SolverSpec:
    name: str
    generalized: bool
    selecting: bool
    family: str              # lapack | scalapack | eigenexa | elpa | extra
    core: str                # eigh | one_stage | two_stage | jacobi | qdwh
    reduction: Optional[str]  # None | 'scalapack' | 'elpa'
    single_device: bool = False
    description: str = ""


def _s(name, generalized, selecting, family, core, reduction,
       single_device=False, description=""):
    return SolverSpec(name, generalized, selecting, family, core, reduction,
                      single_device, description)


SOLVERS: dict[str, SolverSpec] = {s.name: s for s in [
    _s("lapack", False, False, "lapack", "eigh", None, True,
       "replicated single-device solve (dsyev analog)"),
    _s("scalapack", False, False, "scalapack", "one_stage", None,
       description="tridiag + tridiagonal solve + back-transform "
                   "(pdsytrd/pdstedc/pdormtr analog)"),
    _s("scalapack_select", False, True, "scalapack", "one_stage", None,
       description="partial spectrum via bisection/inverse iteration "
                   "(pdsyevx analog)"),
    _s("general_scalapack", True, False, "scalapack", "one_stage",
       "scalapack", description="solver 'A': pdpotrf+pdsygst reduction"),
    _s("general_scalapack_select", True, True, "scalapack", "one_stage",
       "scalapack"),
    _s("general_scalapacknew_eigens", True, False, "scalapack", "one_stage",
       "scalapack_new",
       description="pdsyngst-variant (half-matrix) reduction + eigen_s "
                   "core (generalized_to_standard.f90:48-89)"),
    _s("eigensx", False, False, "eigenexa", "two_stage", None,
       description="two-stage (full->band->tridiag) reduction, eigen_sx "
                   "analog"),
    _s("general_scalapack_eigensx", True, False, "eigenexa", "two_stage",
       "scalapack", description="solver 'B'"),
    _s("general_scalapack_eigens", True, False, "eigenexa", "one_stage",
       "scalapack"),
    _s("general_elpa_scalapack", True, False, "elpa", "one_stage", "elpa",
       description="solver 'C': ELPA-style reduction, pdsyevd-analog core"),
    _s("general_elpa1", True, False, "elpa", "one_stage", "elpa",
       description="solver 'E'"),
    _s("general_elpa2", True, False, "elpa", "two_stage", "elpa",
       description="solver 'D'"),
    _s("general_elpa_eigensx", True, False, "elpa", "two_stage", "elpa",
       description="solver 'G' (flagship hybrid)"),
    _s("general_elpa_eigens", True, False, "elpa", "one_stage", "elpa",
       description="solver 'F'"),
    # TPU-native extras
    _s("eigh", False, False, "extra", "eigh", None,
       description="XLA QDWH eigensolver (TPU-native extra)"),
    _s("general_eigh", True, False, "extra", "eigh", "elpa",
       description="ELPA-style reduction + XLA QDWH (TPU-native extra)"),
    _s("jacobi", False, False, "extra", "jacobi", None,
       description="block-Jacobi: batched pair eigh + GEMM rotations, no "
                   "sequential panels (TPU-native extra)"),
    _s("general_jacobi", True, False, "extra", "jacobi", "elpa",
       description="ELPA-style reduction + block-Jacobi core "
                   "(TPU-native extra)"),
    _s("qdwh_dc", False, False, "extra", "qdwh", None,
       description="in-tree QDWH polar spectral divide-and-conquer: "
                   "sign-function projector splitting, all-GEMM critical "
                   "path (TPU-native extra)"),
    _s("general_qdwh_dc", True, False, "extra", "qdwh", "elpa",
       description="ELPA-style reduction + QDWH spectral D&C core "
                   "(TPU-native extra)"),
]}


AUTO_NAMES = ("auto", "general_auto")


def resolve_auto(name: str, n: int, generalized: bool, selecting: bool,
                 on_mesh: bool, backend: str) -> str:
    """Resolve ``-s auto`` to a concrete registry name.

    The JAX package's rule, unchanged: a selecting run takes the
    pdsyevx-analog name; the ``backend == "tpu"`` branches pick ``eigh``
    for small n and the two-stage core for large n from TPU measurements,
    and never fire in this package; everything else takes the one-stage
    core (``scalapack``, or the pdsyngst-style reduction for generalized
    problems).
    """
    import os

    if name not in AUTO_NAMES:
        return name
    if generalized != name.startswith("general"):
        kind = "generalized" if generalized else "standard"
        raise UnknownSolverError(f"solver '{name}' is not for {kind} "
                                 f"problems (use "
                                 f"'{AUTO_NAMES[int(generalized)]}')")
    if selecting:
        return ("general_scalapack_select" if generalized
                else "scalapack_select")
    eigh_max = int(os.environ.get("EK_AUTO_EIGH_MAX", "1024"))
    if backend == "tpu" and not on_mesh and n <= eigh_max:
        return "general_eigh" if generalized else "eigh"
    twostage_min = int(os.environ.get("EK_AUTO_TWOSTAGE_MIN", "12288"))
    if backend == "tpu" and not on_mesh and n >= twostage_min:
        return "general_elpa_eigensx" if generalized else "eigensx"
    return "general_scalapacknew_eigens" if generalized else "scalapack"


class UnknownSolverError(ValueError):
    pass


def get_spec(name: str) -> SolverSpec:
    try:
        return SOLVERS[name]
    except KeyError:
        raise UnknownSolverError(
            f"eigen_solver: Unknown solver '{name}'") from None


def solver_names() -> list[str]:
    return list(SOLVERS)
