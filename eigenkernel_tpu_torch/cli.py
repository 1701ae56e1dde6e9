"""The end-to-end CLI (main.f90 analog), ``python -m
eigenkernel_tpu_torch``.

Counterpart of ``eigenkernel_tpu/cli.py`` with the same run shape, output
lines, output files and event names:

  parse args -> probe header -> validate -> read MM file -> place on the
  device -> solve -> write eigenvalues.dat -> optional eigenvector files ->
  ipratios.dat -> optional residual / orthogonality checks -> log.json

One process on one device; a second matrix file makes a generalized
problem (B SPD), whose checks and ipratios use the B metric.  Several
processes (``EK_NUM_PROCESSES``), ``--mesh`` and ``--profile`` are not
ported yet and print ``[Error] ...``; so does ``--platform cuda`` (the
default) on a machine without a CUDA device: nothing falls back to the CPU.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np


def _print_select_report(values: np.ndarray, rel_tol: float = 1e-8) -> None:
    """Eigenvalue-cluster diagnostics for selecting solvers — the
    pdsyevx_report analog (solver_scalapack_select.f90:104-135).  Clusters
    are handled by shift separation + CholeskyQR2, so this is
    informational."""
    if values.size < 2:
        return
    span = max(float(values[-1] - values[0]), 1e-300)
    gaps = np.diff(values)
    in_cluster = gaps < rel_tol * span
    n_clusters = 0
    largest = 1
    run = 1
    for flag in in_cluster:
        if flag:
            run += 1
        else:
            if run > 1:
                n_clusters += 1
                largest = max(largest, run)
            run = 1
    if run > 1:
        n_clusters += 1
        largest = max(largest, run)
    if n_clusters:
        print(f"selecting solver: {n_clusters} eigenvalue cluster(s) "
              f"(largest size {largest}, rel gap < {rel_tol:g}); "
              f"orthogonality enforced by shift separation + CholeskyQR2")


def _unsupported(arg) -> str | None:
    """Why this run cannot go ahead in this package, or None."""
    if os.environ.get("EK_NUM_PROCESSES", "") not in ("", "0", "1"):
        return ("multi-process runs (EK_NUM_PROCESSES) are not ported yet "
                "(ROADMAP slice 7)")
    if arg.mesh_shape is not None:
        return "--mesh: multi-device runs are not ported yet (ROADMAP slice 7)"
    if arg.profile_dir:
        return "--profile is not ported yet"
    return None


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    t_start = time.time()

    import torch

    from eigenkernel_tpu_torch.core import config as cfg
    from eigenkernel_tpu_torch.io import matrix_market as mm
    from eigenkernel_tpu_torch.io import outputs
    from eigenkernel_tpu_torch.obs.events import EventLog
    from eigenkernel_tpu_torch.solvers.api import solve
    from eigenkernel_tpu_torch.solvers.registry import (
        AUTO_NAMES, UnknownSolverError, get_spec, resolve_auto)
    from eigenkernel_tpu_torch.verify import (
        eval_orthogonality, eval_residual_norm, get_ipratios)

    log = EventLog(stream=True, epoch=t_start)

    try:
        arg = cfg.parse_args(argv)
    except cfg.ArgumentError as exc:
        print(f"[Error] {exc}", file=sys.stderr)
        return 1
    why = _unsupported(arg)
    if why is not None:
        print(f"[Error] {why}", file=sys.stderr)
        return 1
    if arg.platform == "cuda" and not torch.cuda.is_available():
        print("[Error] --platform cuda: no CUDA device is available "
              "(use --platform cpu to run on the CPU)", file=sys.stderr)
        return 1
    device = torch.device(arg.platform)
    cfg.set_matmul_precision_highest()

    # --- header probe (wrap_mminfo analog)
    t0 = time.time()
    try:
        arg.matrix_A_info = mm.read_header(arg.matrix_A_filename)
        if arg.is_generalized_problem:
            arg.matrix_B_info = mm.read_header(arg.matrix_B_filename)
    except (OSError, mm.MatrixMarketError) as exc:
        print(f"[Error] mminfo failed: {exc}", file=sys.stderr)
        return 1
    cfg.finalize_args(arg)

    device_name = torch.cuda.get_device_name(device) \
        if device.type == "cuda" else "cpu"
    print("---------- Eigen Test start ----------")
    print("----- Configurations -----")
    cfg.print_command_argument(arg)
    mem = cfg.required_memory(arg)
    if mem > 0:
        print(f"approximate required memory per device (Mbytes): "
              f"{mem / 2**20:10.1f}")
    print(f"devices: 1 ({device.type}: {device_name}), processes: 1")
    log.add_event("main:read_command_argument", time.time() - t0)

    if arg.solver_type in AUTO_NAMES:
        dim = arg.matrix_A_info.rows
        try:
            arg.solver_type = resolve_auto(
                arg.solver_type, dim, generalized=arg.is_generalized_problem,
                selecting=arg.n_vec != dim, on_mesh=False,
                backend=device.type)
        except UnknownSolverError as exc:
            print(f"[Error] {exc}", file=sys.stderr)
            return 1
        print(f"auto solver resolved: {arg.solver_type}")

    try:
        cfg.validate_args(arg)
    except (cfg.ArgumentError, UnknownSolverError) as exc:
        print(f"[Error] {exc}", file=sys.stderr)
        return 1
    spec = get_spec(arg.solver_type)

    # --- read the matrix (read_matrix_file analog)
    t0 = time.time()
    try:
        mat_a = mm.read_matrix(arg.matrix_A_filename, arg.matrix_A_info, log)
        mat_b = mm.read_matrix(arg.matrix_B_filename, arg.matrix_B_info,
                               log) if arg.is_generalized_problem else None
    except (OSError, mm.MatrixMarketError) as exc:
        print(f"[Error] read_matrix_file failed: {exc}", file=sys.stderr)
        return 1
    log.add_event("main:read_matrix_files", time.time() - t0)

    # --- densify and place on the device (bcast_sparse_matrix analog)
    t0 = time.time()
    dtype = torch.float32 if arg.dtype == "float32" else torch.float64
    a_mat = torch.from_numpy(mat_a.to_dense()).to(device=device, dtype=dtype)
    b_mat = None if mat_b is None else \
        torch.from_numpy(mat_b.to_dense()).to(device=device, dtype=dtype)
    if arg.is_printing_grid_mapping:
        print("Grid mapping (1 x 1):")
        print(f"  (0, 0) -> {device} {device_name}")
    log.add_event("main:bcast_sparse_matrices", time.time() - t0)

    command = "eigenkernel_app " + " ".join(argv)
    block_used = arg.block_size or cfg.DEFAULT_BLOCK_SIZE
    if arg.is_dry_run:
        print("\ndry run mode, exit")
        outputs.write_log_json(arg.log_filename,
                               cfg.settings_json(arg, command, block_used),
                               log)
        return 0

    # --- solve (eigen_solver analog)
    print("\n----- Solver Call -----")
    t0 = time.time()
    try:
        pairs = solve(a_mat, b_mat, solver=arg.solver_type,
                      n_vec=arg.n_vec if spec.selecting else None,
                      block_size=arg.block_size, log=log,
                      dtype="mixed" if arg.dtype == "mixed" else None,
                      device=device)
    except Exception as exc:
        # terminate() analog: dump accumulated events, then fail with a
        # coherent message
        log.print_events(file=sys.stderr)
        print(f"[Error] eigen_solver failed: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        return 1
    log.add_event("main:eigen_solver", time.time() - t0)

    values_host = pairs.values.double().cpu().numpy()
    if spec.selecting:
        _print_select_report(values_host)

    # --- outputs
    t0 = time.time()
    outputs.write_eigenvalues(arg.output_filename, values_host)
    if arg.printed_vecs_ranges:
        outputs.print_eigenvectors(pairs, arg.eigenvector_dir,
                                   arg.printed_vecs_ranges,
                                   arg.is_binary_output)
    log.add_event("main:print_eigenpairs", time.time() - t0)

    t0 = time.time()
    outputs.write_ipratios(arg.ipratios_filename, get_ipratios(pairs, b_mat))
    log.add_event("main:compute_and_print_ipratios", time.time() - t0)

    # --- checks
    t0 = time.time()
    if arg.n_check_vec != 0:
        print("\n----- Checker Call -----")
        a_norm, rn_ave, rn_max = eval_residual_norm(a_mat, pairs,
                                                    arg.n_check_vec, b_mat)
        print(f"A norm: {a_norm:15.8E}")
        print(f"residual norm (average): {rn_ave:15.8E}")
        print(f"residual norm (max):     {rn_max:15.8E}")
    log.add_event("main:eval_residual_norm", time.time() - t0)

    t0 = time.time()
    if arg.ortho_check_index_start != 0:
        ortho = eval_orthogonality(pairs, arg.ortho_check_index_start,
                                   arg.ortho_check_index_end, b_mat)
        print(f"orthogonality criterion: {ortho:15.8E}")
    log.add_event("main:eval_orthogonality", time.time() - t0)
    log.add_event("main", time.time() - t_start)

    outputs.write_log_json(arg.log_filename,
                           cfg.settings_json(arg, command, block_used), log)
    if arg.verbose_level > 0:
        log.print_events()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
