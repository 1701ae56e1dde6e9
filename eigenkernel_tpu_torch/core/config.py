"""Runtime configuration: CLI argument parsing, validation, memory estimate.

Counterpart of ``eigenkernel_tpu/core/config.py`` (reference:
command_argument.f90), with the same argv grammar:
``-s -n -c -o -i -d -p -t -l -v -h --block-size --dry-run
--print-grid-mapping --binary --dtype --mesh --platform --profile`` and
positional ``matrix_A [matrix_B]``.  ``--platform`` takes ``cuda`` (the
default) or ``cpu``.  Validation checks solver names against the port's
registry.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Optional

import torch

from eigenkernel_tpu_torch.core.types import MatrixInfo
from eigenkernel_tpu_torch.version import VERSION

MAX_PRINTED_VECS_RANGES = 100
DEFAULT_BLOCK_SIZE = 64  # g_block_size default (global_variables.f90:5)
PLATFORMS = ("cuda", "cpu")


class ArgumentError(ValueError):
    pass


@dataclass
class Args:
    matrix_A_filename: str = ""
    matrix_B_filename: str = ""   # empty => standard eigenvalue problem
    log_filename: str = "log.json"
    matrix_A_info: MatrixInfo = field(default_factory=MatrixInfo)
    matrix_B_info: MatrixInfo = field(default_factory=MatrixInfo)
    solver_type: str = ""
    output_filename: str = "eigenvalues.dat"
    ipratios_filename: str = "ipratios.dat"
    is_generalized_problem: bool = False
    is_printing_grid_mapping: bool = False
    is_dry_run: bool = False
    is_binary_output: bool = False
    block_size: int = 0           # 0 => default block size
    n_vec: int = -1               # -1 => all vectors
    n_check_vec: int = 0          # 0 => no residual check; -1 => all
    ortho_check_index_start: int = 0  # 0 => no orthogonality check
    ortho_check_index_end: int = 0
    eigenvector_dir: str = "."
    printed_vecs_ranges: list[tuple[int, int]] = field(default_factory=list)
    verbose_level: int = 0
    # --- extensions beyond the reference ---
    dtype: str = "float64"
    mesh_shape: Optional[tuple[int, int]] = None
    platform: str = "cuda"
    profile_dir: str = ""


HELP_TEXT = f"""\
Usage: python -m eigenkernel_tpu_torch -s <solver_type> <options> <matrix_A>
{VERSION}
Solver types that run in this package (a second matrix file, B, makes a
generalized problem):
  scalapack (standard): Householder tridiagonalization, divide and
            conquer, WY back-transform
  scalapack_select (standard, selecting): the same with Sturm bisection
            + inverse iteration for the lowest -n eigenpairs
  eigensx (standard): two-stage reduction (full -> band -> tridiagonal)
  lapack, eigh (standard): torch.linalg.eigh
  auto (standard): resolves to scalapack or scalapack_select
  general_scalapack, general_scalapack_select, general_scalapacknew_eigens,
  general_scalapack_eigensx, general_scalapack_eigens,
  general_elpa_scalapack, general_elpa1, general_elpa2,
  general_elpa_eigensx, general_elpa_eigens, general_eigh (generalized):
            Cholesky reduction (trsm, half-matrix or explicit inverse),
            one of the cores above, recovery
  general_auto (generalized): resolves to general_scalapacknew_eigens or
            general_scalapack_select
jacobi, qdwh_dc and their general_ forms are recognised and refused.
Options are:
  -n <num>  (available with selecting solvers) Compute only <num> eigenpairs
            in ascending order of their eigenvalues
  -c <num>  Consider only <num> eigenvectors in residual norm checking.
            Default is 0. Set -1 to consider all the vectors
  -o <file>  Set output file name for eigenvalues to <file>
  -i <file>  Set output file name for ipratios to <file>
  -d <dir>  Set output files directory for eigenvectors to <dir>
  -p <num1>[-<num2>][,...]  Specify index ranges of eigenvectors to be output
  -t <num1>,<num2>  Consider eigenvectors indexed <num1> to <num2> (included)
            in orthogonality checking
  -l <file>  Set output file name for elapse time log to <file>
  -h  Print this help and exit
  --block-size <n>  Householder panel width (default {DEFAULT_BLOCK_SIZE})
  --dry-run  Read command arguments and matrix files and instantly exit
  --print-grid-mapping  Print which device is assigned to each grid coordinate
  --binary  Output eigenvectors as binary files
Extensions:
  --dtype <float64|float32>  Compute precision (default float64)
  --platform <cuda|cpu>  Device to solve on (default cuda)
"""


def parse_index_ranges(s: str) -> list[tuple[int, int]]:
    """Parse ``1-30,40,50-60`` into [(1,30),(40,40),(50,60)] (1-based)."""
    ranges: list[tuple[int, int]] = []
    for part in s.split(","):
        part = part.strip()
        if not part:
            raise ArgumentError("parse_index_ranges: invalid comma placement")
        if "-" in part[1:]:
            a, b = part.split("-", 1)
            if not a:
                raise ArgumentError("parse_index_ranges: invalid hyphen placement")
            lo, hi = int(a), int(b)
        else:
            lo = hi = int(part)
        ranges.append((lo, hi))
        if len(ranges) > MAX_PRINTED_VECS_RANGES:
            raise ArgumentError(
                f"parse_index_ranges: too many ranges (> {MAX_PRINTED_VECS_RANGES})")
    return ranges


def parse_args(argv: list[str]) -> Args:
    """Parse the reference CLI surface into :class:`Args` (no file IO here)."""
    arg = Args()
    i = 0

    def take_value(flag: str) -> str:
        nonlocal i
        i += 1
        if i >= len(argv):
            raise ArgumentError(f"parse_args: missing value for {flag}")
        return argv[i]

    while i < len(argv):
        a = argv[i]
        if a.startswith("-") and a != "-":
            key = a[1:]
            if key == "s":
                arg.solver_type = take_value(a)
            elif key == "n":
                arg.n_vec = int(take_value(a))
            elif key == "c":
                arg.n_check_vec = int(take_value(a))
            elif key == "o":
                arg.output_filename = take_value(a)
            elif key == "i":
                arg.ipratios_filename = take_value(a)
            elif key == "d":
                arg.eigenvector_dir = take_value(a)
            elif key == "p":
                arg.printed_vecs_ranges = parse_index_ranges(take_value(a))
            elif key == "t":
                v = take_value(a)
                if "," not in v:
                    raise ArgumentError("parse_args: wrong format for -t option")
                s1, s2 = v.split(",", 1)
                arg.ortho_check_index_start = int(s1)
                arg.ortho_check_index_end = int(s2)
            elif key == "v":
                arg.verbose_level = 1
            elif key == "l":
                arg.log_filename = take_value(a)
            elif key == "h":
                print(HELP_TEXT)
                raise SystemExit(0)
            elif key == "-block-size":
                arg.block_size = int(take_value(a))
            elif key == "-dry-run":
                arg.is_dry_run = True
            elif key == "-print-grid-mapping":
                arg.is_printing_grid_mapping = True
            elif key == "-binary":
                arg.is_binary_output = True
            elif key == "-dtype":
                arg.dtype = take_value(a)
            elif key == "-mesh":
                r, c = take_value(a).split(",")
                arg.mesh_shape = (int(r), int(c))
            elif key == "-platform":
                arg.platform = take_value(a)
            elif key == "-profile":
                arg.profile_dir = take_value(a)
            else:
                print(HELP_TEXT)
                raise ArgumentError(f"parse_args: unknown option {a}")
        elif not arg.matrix_A_filename:
            arg.matrix_A_filename = a
        else:
            arg.matrix_B_filename = a
        i += 1

    if not arg.matrix_A_filename:
        raise ArgumentError("parse_args: Matrix A file not specified")
    arg.is_generalized_problem = bool(arg.matrix_B_filename)
    if arg.dtype not in ("float64", "float32", "mixed"):
        raise ArgumentError(f"parse_args: unsupported dtype {arg.dtype}")
    if arg.platform not in PLATFORMS:
        raise ArgumentError(f"parse_args: unsupported platform {arg.platform} "
                            f"(use one of {', '.join(PLATFORMS)})")
    return arg


def finalize_args(arg: Args) -> None:
    """Fill header-derived defaults (reference: end of read_command_argument).

    Requires ``matrix_A_info`` (and B) to be populated by a header probe.
    """
    if arg.n_vec == -1:
        arg.n_vec = arg.matrix_A_info.rows
    if arg.n_check_vec == -1:
        arg.n_check_vec = arg.n_vec


def validate_args(arg: Args) -> None:
    from eigenkernel_tpu_torch.solvers.registry import get_spec

    dim = arg.matrix_A_info.rows
    ok_size = dim == arg.matrix_A_info.cols
    if arg.is_generalized_problem:
        ok_size = ok_size and dim == arg.matrix_B_info.rows \
            and dim == arg.matrix_B_info.cols
    if not ok_size:
        raise ArgumentError("validate_args: Matrix dimension mismatch")

    spec = get_spec(arg.solver_type)  # raises on unknown solver
    if spec.generalized != arg.is_generalized_problem:
        kind = "generalized" if arg.is_generalized_problem else "standard"
        raise ArgumentError(
            f"validate_args: solver '{arg.solver_type}' is not for "
            f"{kind} eigenvalue problem")

    if not spec.selecting and arg.n_vec != dim:
        raise ArgumentError(
            f"validate_args: Solver '{arg.solver_type}' does not support "
            f"partial eigenvalue computation")
    if spec.selecting and not (0 < arg.n_vec <= dim):
        raise ArgumentError("validate_args: -n out of range")

    for lo, hi in arg.printed_vecs_ranges:
        if lo < 1 or hi < 1 or hi > arg.n_vec or lo > hi:
            raise ArgumentError(
                "validate_args: Specified numbers with -p option are not valid")
    if arg.n_check_vec < 0 or arg.n_check_vec > arg.n_vec:
        raise ArgumentError(
            "validate_args: Specified numbers with -c option are not valid")
    if arg.ortho_check_index_start < 0 or arg.ortho_check_index_end < 0 or \
            arg.ortho_check_index_end > arg.n_vec or \
            arg.ortho_check_index_start > arg.ortho_check_index_end:
        raise ArgumentError(
            "validate_args: Specified numbers with -t option are not valid")


def required_memory(arg: Args, n_dev: int = 1) -> float:
    """Approximate bytes per device on ``n_dev`` devices
    (command_argument.f90:318-335; JAX ``core/config.py:267``); -1 for
    solvers the reference had no formula for.  On a process grid a rank
    of ``scalapack`` / ``scalapack_select`` holds its block of A, its 1/P
    of the reflectors and its columns of the eigenvectors, so its share
    shrinks with ``n_dev`` as the formula's does; ``lapack`` runs
    replicated and its formula has no ``n_dev``."""
    itemsize = 8 if arg.dtype == "float64" else 4
    nnz_a = arg.matrix_A_info.entries
    dim = float(arg.matrix_A_info.rows)
    st = arg.solver_type
    if st in ("lapack", "eigh"):
        return itemsize * (nnz_a + dim * dim)
    if st in ("scalapack", "scalapack_select"):
        return itemsize * (nnz_a + dim * dim * 2.0 / n_dev)
    if st in ("general_scalapack", "general_scalapack_select",
              "general_eigh"):
        nnz = nnz_a + arg.matrix_B_info.entries
        return itemsize * (nnz + dim * dim * 3.0 / n_dev)
    return -1.0


def settings_json(arg: Args, command: str, block_size_used: int) -> dict:
    """The ``setting`` object of log.json (fson_setting_add parity)."""
    return {
        "version": VERSION,
        "command": command,
        "matrix_A_filename": arg.matrix_A_filename,
        "matrix_B_filename": arg.matrix_B_filename,
        "log_filename": arg.log_filename,
        "dimension": arg.matrix_A_info.rows,
        "solver": arg.solver_type,
        "g_block_size": block_size_used,
        "block_size": arg.block_size,
    }


def print_command_argument(arg: Args, file=None) -> None:
    """Human-readable configuration report (print_command_argument analog)."""
    file = file or sys.stdout
    kind = "generalized" if arg.is_generalized_problem else "standard"
    print(f"problem type: {kind}", file=file)
    print(f"matrix A file: {arg.matrix_A_filename}", file=file)
    if arg.is_generalized_problem:
        print(f"matrix B file: {arg.matrix_B_filename}", file=file)
    print(f"solver: {arg.solver_type}", file=file)
    print(f"eigenvalues output file: {arg.output_filename}", file=file)
    print(f"ipratios output file: {arg.ipratios_filename}", file=file)
    print(f"log output file: {arg.log_filename}", file=file)
    print(f"dtype: {arg.dtype}", file=file)


def set_matmul_precision_highest() -> None:
    """Full-float32 matrix products: TF32 keeps about three decimal digits,
    which would hide the solver's true residual (the JAX package's
    ``"highest"`` precision rule)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
