"""The end-to-end CLI (main.f90 analog), ``python -m
eigenkernel_tpu_torch``.

Counterpart of ``eigenkernel_tpu/cli.py`` with the same run shape, output
lines, output files and event names:

  parse args -> probe header -> validate -> read MM file -> place on the
  device -> solve -> write eigenvalues.dat -> optional eigenvector files ->
  ipratios.dat -> optional residual / orthogonality checks -> log.json

A second matrix file makes a generalized problem (B SPD), whose checks
and ipratios use the B metric.  ``--platform cuda`` (the default) on a
machine without a CUDA device prints ``[Error] ...``: nothing falls back
to the CPU.

Several processes (JAX ``cli.py:82-300``): ``EK_NUM_PROCESSES``,
``EK_COORDINATOR`` (``host:port``) and ``EK_PROCESS_ID`` start each
process in one ``torch.distributed`` group (NCCL on the card, a card
each; gloo with ``--platform cpu``), on an R x C grid (``--mesh R,C``,
default the near-square layout).  Process 0 probes the header and reads
the COO triplets, broadcasts them, and each process densifies its own
block (of A, and of B for a generalized problem); eigenvalues.dat,
ipratios.dat and log.json come from process 0, the eigenvector files from
every process in turn.  Every name runs on a grid, in every ``--dtype``
(``mixed``: the float64 blocks of A and B are the ones densified here).
``--profile <dir>`` traces the solve with ``torch.profiler`` into
``<dir>/trace_rank<r>.json``, and writes beside it
``<dir>/spans_rank<r>.json``: every kernel and idle gap of the solve put
down to the program's spans (``obs/profile.py::summarize``).
"""

from __future__ import annotations

import contextlib
import json
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


def _profiler(arg, device):
    """torch.profiler around the solve with ``--profile``, else nothing."""
    import torch

    if not arg.profile_dir:
        return contextlib.nullcontext()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    t_start = time.time()

    import torch
    import torch.distributed as dist

    from eigenkernel_tpu_torch.core import config as cfg
    from eigenkernel_tpu_torch.parallel import multihost as mh

    try:
        arg = cfg.parse_args(argv)
    except cfg.ArgumentError as exc:
        print(f"[Error] {exc}", file=sys.stderr)
        return 1
    n_proc = int(os.environ.get("EK_NUM_PROCESSES", "0") or 0)
    if arg.platform == "cuda" and not torch.cuda.is_available():
        print("[Error] --platform cuda: no CUDA device is available "
              "(use --platform cpu to run on the CPU)", file=sys.stderr)
        return 1
    if arg.platform == "cuda" and n_proc > torch.cuda.device_count():
        print(f"[Error] {n_proc} processes would share "
              f"{torch.cuda.device_count()} CUDA device(s): one process a "
              f"card", file=sys.stderr)
        return 1
    pid = os.environ.get("EK_PROCESS_ID")
    joined = not dist.is_initialized()
    try:
        mh.init_distributed(os.environ.get("EK_COORDINATOR"), n_proc or None,
                            None if pid is None else int(pid),
                            "gloo" if arg.platform == "cpu" else "nccl")
    except ValueError as exc:
        print(f"[Error] {exc}", file=sys.stderr)
        return 1
    joined = joined and dist.is_initialized()
    try:
        return _main(arg, argv, t_start)
    finally:
        if joined:
            dist.destroy_process_group()


def _main(arg, argv, t_start) -> int:
    import torch

    from eigenkernel_tpu_torch.core import config as cfg
    from eigenkernel_tpu_torch.io import matrix_market as mm
    from eigenkernel_tpu_torch.io import outputs
    from eigenkernel_tpu_torch.obs import events
    from eigenkernel_tpu_torch.obs.events import EventLog
    from eigenkernel_tpu_torch.obs.profile import summarize
    from eigenkernel_tpu_torch.parallel import mesh as pm
    from eigenkernel_tpu_torch.parallel import multihost as mh
    from eigenkernel_tpu_torch.solvers.api import solve
    from eigenkernel_tpu_torch.solvers.registry import (
        AUTO_NAMES, UnknownSolverError, get_spec, resolve_auto)
    from eigenkernel_tpu_torch.verify import (
        eval_orthogonality, eval_residual_norm, get_ipratios)

    n_proc, rank = mh.process_count(), mh.process_index()
    master = rank == 0
    log = EventLog(stream=master, epoch=t_start)
    if arg.mesh_shape is not None and \
            arg.mesh_shape[0] * arg.mesh_shape[1] != n_proc:
        r, c = arg.mesh_shape
        print(f"[Error] --mesh {r},{c} needs {r * c} processes "
              f"(EK_NUM_PROCESSES, EK_COORDINATOR, EK_PROCESS_ID); this "
              f"run has {n_proc}", file=sys.stderr)
        return 1
    if arg.platform == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    cfg.set_matmul_precision_highest()

    # --- header probe on process 0 + info broadcast (wrap_mminfo +
    # bcast_matrix_info analog)
    t0 = time.time()
    info_a = info_b = err = None
    if master:
        try:
            info_a = mm.read_header(arg.matrix_A_filename)
            if arg.is_generalized_problem:
                info_b = mm.read_header(arg.matrix_B_filename)
        except (OSError, mm.MatrixMarketError) as exc:
            err = exc
    arg.matrix_A_info = mh.bcast_matrix_info(info_a)
    if arg.is_generalized_problem:
        arg.matrix_B_info = mh.bcast_matrix_info(info_b)
    if arg.matrix_A_info is None or \
            (arg.is_generalized_problem and arg.matrix_B_info is None):
        if master:
            print(f"[Error] mminfo failed: {err}", file=sys.stderr)
        return 1
    cfg.finalize_args(arg)

    device_name = torch.cuda.get_device_name(device) \
        if device.type == "cuda" else "cpu"
    if master:
        print("---------- Eigen Test start ----------")
        print("----- Configurations -----")
        cfg.print_command_argument(arg)
        mem = cfg.required_memory(arg, n_proc)
        if mem > 0:
            print(f"approximate required memory per device (Mbytes): "
                  f"{mem / 2**20:10.1f}")
        print(f"devices: {n_proc} ({device.type}: {device_name}), "
              f"processes: {n_proc}")
    log.add_event("main:read_command_argument", time.time() - t0)

    if arg.solver_type in AUTO_NAMES:
        dim = arg.matrix_A_info.rows
        try:
            arg.solver_type = resolve_auto(
                arg.solver_type, dim, generalized=arg.is_generalized_problem,
                selecting=arg.n_vec != dim, on_mesh=n_proc > 1,
                backend=device.type)
        except UnknownSolverError as exc:
            print(f"[Error] {exc}", file=sys.stderr)
            return 1
        if master:
            print(f"auto solver resolved: {arg.solver_type}")

    try:
        cfg.validate_args(arg)
    except (cfg.ArgumentError, UnknownSolverError) as exc:
        print(f"[Error] {exc}", file=sys.stderr)
        return 1
    spec = get_spec(arg.solver_type)

    # --- read the matrices on process 0 (read_matrix_file analog); COO
    # only, densified after the broadcast
    t0 = time.time()
    mat_a = mat_b = None
    ok = True
    if master:
        try:
            mat_a = mm.read_matrix(arg.matrix_A_filename, arg.matrix_A_info,
                                   log)
            if arg.is_generalized_problem:
                mat_b = mm.read_matrix(arg.matrix_B_filename,
                                       arg.matrix_B_info, log)
        except (OSError, mm.MatrixMarketError) as exc:
            ok = False
            print(f"[Error] read_matrix_file failed: {exc}", file=sys.stderr)
    if not mh.bcast_ok(ok):
        return 1
    log.add_event("main:read_matrix_files", time.time() - t0)

    # --- grid, COO broadcast and densify: each process its own block
    # (bcast_sparse_matrix analog)
    t0 = time.time()
    dtype = torch.float32 if arg.dtype == "float32" else torch.float64
    grid = pm.make_mesh(arg.mesh_shape, device) if n_proc > 1 else None
    mat_a = mh.bcast_coo(mat_a, arg.matrix_A_info.rows,
                         arg.matrix_A_info.entries)
    if arg.is_generalized_problem:
        mat_b = mh.bcast_coo(mat_b, arg.matrix_B_info.rows,
                             arg.matrix_B_info.entries)
    if grid is not None:
        a_mat = pm.distribute_coo(mat_a, grid, dtype)
        b_mat = None if mat_b is None else \
            pm.distribute_coo(mat_b, grid, dtype)
    else:
        a_mat = torch.from_numpy(mat_a.to_dense()).to(device=device,
                                                      dtype=dtype)
        b_mat = None if mat_b is None else \
            torch.from_numpy(mat_b.to_dense()).to(device=device, dtype=dtype)
    del mat_a, mat_b
    if arg.is_printing_grid_mapping and master:
        if grid is not None:
            pm.print_grid_mapping(grid)
        else:
            print("Grid mapping (1 x 1):")
            print(f"  (0, 0) -> {device} {device_name}")
    log.add_event("main:bcast_sparse_matrices", time.time() - t0)

    command = "eigenkernel_app " + " ".join(argv)
    block_used = arg.block_size or cfg.DEFAULT_BLOCK_SIZE
    if arg.is_dry_run:
        if master:
            print("\ndry run mode, exit")
            outputs.write_log_json(
                arg.log_filename, cfg.settings_json(arg, command, block_used),
                log)
        return 0

    # --- solve (eigen_solver analog)
    if master:
        print("\n----- Solver Call -----")
    t0 = time.time()
    try:
        with _profiler(arg, device) as prof, \
                events.stage("main:eigen_solver", log):
            pairs = solve(a_mat, b_mat, solver=arg.solver_type,
                          n_vec=arg.n_vec if spec.selecting else None,
                          block_size=arg.block_size, log=log,
                          dtype="mixed" if arg.dtype == "mixed" else None,
                          device=device, mesh=grid)
            if device.type == "cuda":
                with events.span("wait:drain"):
                    torch.cuda.synchronize(device)
    except Exception as exc:
        # terminate() analog: dump accumulated events, then fail with a
        # coherent message
        log.print_events(file=sys.stderr)
        print(f"[Error] eigen_solver failed: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        return 1
    log.add_event("main:eigen_solver", time.time() - t0)
    if prof is not None:
        os.makedirs(arg.profile_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(arg.profile_dir, f"trace_rank{rank}.json"))
        with open(os.path.join(arg.profile_dir, f"spans_rank{rank}.json"),
                  "w") as f:
            json.dump(summarize(prof.profiler.kineto_results.events(),
                                log.spans()), f, indent=1)

    values_host = pairs.values.double().cpu().numpy()
    if spec.selecting and master:
        _print_select_report(values_host)

    # --- outputs (process 0, but the eigenvector files from every process)
    t0 = time.time()
    if master:
        outputs.write_eigenvalues(arg.output_filename, values_host)
    if arg.printed_vecs_ranges:
        outputs.print_eigenvectors(pairs, arg.eigenvector_dir,
                                   arg.printed_vecs_ranges,
                                   arg.is_binary_output)
    log.add_event("main:print_eigenpairs", time.time() - t0)

    t0 = time.time()
    ipr = get_ipratios(pairs, b_mat)
    if master:
        outputs.write_ipratios(arg.ipratios_filename, ipr)
    log.add_event("main:compute_and_print_ipratios", time.time() - t0)

    # --- checks (collective on a grid, process 0 prints)
    t0 = time.time()
    if arg.n_check_vec != 0:
        if master:
            print("\n----- Checker Call -----")
        a_norm, rn_ave, rn_max = eval_residual_norm(a_mat, pairs,
                                                    arg.n_check_vec, b_mat)
        if master:
            print(f"A norm: {a_norm:15.8E}")
            print(f"residual norm (average): {rn_ave:15.8E}")
            print(f"residual norm (max):     {rn_max:15.8E}")
    log.add_event("main:eval_residual_norm", time.time() - t0)

    t0 = time.time()
    if arg.ortho_check_index_start != 0:
        ortho = eval_orthogonality(pairs, arg.ortho_check_index_start,
                                   arg.ortho_check_index_end, b_mat)
        if master:
            print(f"orthogonality criterion: {ortho:15.8E}")
    log.add_event("main:eval_orthogonality", time.time() - t0)
    log.add_event("main", time.time() - t_start)

    if master:
        outputs.write_log_json(arg.log_filename,
                               cfg.settings_json(arg, command, block_used),
                               log)
        if arg.verbose_level > 0:
            log.print_events()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
