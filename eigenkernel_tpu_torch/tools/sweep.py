"""Every ``-s`` name on one problem: the solver sweep (the reference's
raison d'être, README.md:4-5: "test various combinations ... and find the
best one").  Counterpart of the JAX package's ``scripts/sweep.py``.

    python -m eigenkernel_tpu_torch.tools.sweep [--n 2048]
        [--dtype float32|float64|mixed] [--generalized] [--mesh R,C]
        [--matrix A.mtx [--matrix-b B.mtx]] [--solvers name1,name2,...]
        [--select-k K] [--platform cpu]

Solves the same problem (a random symmetric matrix of seed 0, with an SPD
pencil under ``--generalized``, or MatrixMarket files) by every
applicable registry name (the full-spectrum names; with ``--select-k K``
the selecting ones too, at K pairs), each once untimed (the kernels'
build and the libraries' start-up) and once timed: solve seconds (host
clock, ending in a synchronize), each stage's seconds (``log.json``
events), the residual and orthogonality of the first 64 pairs (B metric
for a pencil).  Prints a JSON line a name, then a table by time.  Runs
on the card by default, on the CPU with ``--platform cpu``.  With
``--mesh R,C`` run it as R x C processes, as the CLI:
``EK_NUM_PROCESSES``, ``EK_COORDINATOR`` and ``EK_PROCESS_ID``; process 0
prints.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

CHECKED_COLS = 64


def _problem(args, host_dtype):
    from eigenkernel_tpu_torch.io import matrix_market as mm

    if args.matrix:
        a = mm.read_matrix(args.matrix).to_dense(host_dtype)
        b = mm.read_matrix(args.matrix_b).to_dense(host_dtype) \
            if args.matrix_b else None
        return a, b
    rng = np.random.default_rng(0)
    n = args.n
    a = rng.standard_normal((n, n))
    a = ((a + a.T) / 2).astype(host_dtype)
    b = None
    if args.generalized:
        br = rng.standard_normal((n, n))
        b = (br @ br.T + n * np.eye(n)).astype(host_dtype)
    return a, b


def _grid(args, device):
    """The process grid of ``--mesh`` (None without it)."""
    if not args.mesh:
        return None
    from eigenkernel_tpu_torch.parallel import mesh as pm
    from eigenkernel_tpu_torch.parallel import multihost as mh

    r, c = (int(x) for x in args.mesh.split(","))
    pid = os.environ.get("EK_PROCESS_ID")
    mh.init_distributed(os.environ.get("EK_COORDINATOR"), r * c,
                        None if pid is None else int(pid),
                        "gloo" if device.type == "cpu" else "nccl")
    if device.type == "cuda":
        device = torch.device("cuda", mh.process_index()
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return pm.make_mesh((r, c), device)


def sweep(args) -> list:
    from eigenkernel_tpu_torch.obs.events import EventLog
    from eigenkernel_tpu_torch.parallel import mesh as pm
    from eigenkernel_tpu_torch.solvers.api import solve
    from eigenkernel_tpu_torch.solvers.registry import SOLVERS
    from eigenkernel_tpu_torch.verify import (eval_orthogonality,
                                              eval_residual_norm)

    if args.platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (use --platform cpu to run on "
                           "the CPU)")
    device = torch.device(args.platform)
    grid = _grid(args, device)
    if grid is not None:
        device = grid.device
    master = grid is None or grid.rank == 0
    host_dtype = np.float32 if args.dtype == "float32" else np.float64
    tdtype = torch.float32 if args.dtype == "float32" else torch.float64
    a, b = _problem(args, host_dtype)
    generalized = b is not None
    n = a.shape[0]
    # placed once: a host operand inside the timed call would add its copy
    # to every name
    if grid is None:
        a_in = torch.tensor(a, device=device)
        b_in = None if b is None else torch.tensor(b, device=device)
    else:
        a_in = pm.distribute(a, grid, tdtype)
        b_in = None if b is None else pm.distribute(b, grid, tdtype)
    if master:
        name = torch.cuda.get_device_name(device) \
            if device.type == "cuda" else "cpu"
        print(f"device: {name}; n={n} dtype={args.dtype} "
              f"generalized={generalized}"
              + (f" grid={grid.R}x{grid.C}" if grid else ""), flush=True)
    names = args.solvers.split(",") if args.solvers else [
        s.name for s in SOLVERS.values()
        if s.generalized == generalized and not s.selecting]
    if args.select_k and not args.solvers:
        names += [s.name for s in SOLVERS.values()
                  if s.generalized == generalized and s.selecting]
    dtype_arg = "mixed" if args.dtype == "mixed" else None

    def run(name, n_vec, log):
        pairs = solve(a_in, b_in, solver=name, n_vec=n_vec, log=log,
                      dtype=dtype_arg, mesh=grid)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return pairs

    rows = []
    for name in names:
        n_vec = (args.select_k or None) if SOLVERS[name].selecting else None
        log = EventLog(stream=False)
        try:
            run(name, n_vec, EventLog(stream=False))
            if grid is not None:
                pm.barrier(grid)
            t0 = time.time()
            p = run(name, n_vec, log)
            dt = time.time() - t0
            k = min(p.values.shape[0], CHECKED_COLS)
            _, _, rmax = eval_residual_norm(a_in, p, k, b_in)
            orth = eval_orthogonality(p, 1, k, b_in)
            rows.append({"solver": name, "time_s": dt,
                         **({"n_vec": n_vec} if n_vec else {}),
                         "resid_max": rmax, "orth": orth,
                         "checked_cols": k,
                         "stages": {e["name"]: e["val"]
                                    for e in log.events()}})
        except Exception as exc:  # keep sweeping (reference: terminate())
            traceback.print_exc(file=sys.stderr)
            rows.append({"solver": name, "error": str(exc)[:120]})
        if master:
            print(json.dumps(rows[-1]), flush=True)
    ok = [r for r in rows if "time_s" in r]
    if ok and master:
        best = min(ok, key=lambda r: r["time_s"])
        print(f"\nbest solver: {best['solver']} ({best['time_s']:.4f}s)")
        print(f"{'solver':32s} {'time[s]':>9s} {'resid_max':>11s} "
              f"{'orth':>11s}")
        for r in sorted(ok, key=lambda r: r["time_s"]):
            print(f"{r['solver']:32s} {r['time_s']:9.4f} "
                  f"{r['resid_max']:11.3e} {r['orth']:11.3e}")
    return rows


def parse(argv):
    ap = argparse.ArgumentParser(prog="python -m "
                                 "eigenkernel_tpu_torch.tools.sweep")
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64", "mixed"])
    ap.add_argument("--generalized", action="store_true")
    ap.add_argument("--mesh", default="")
    ap.add_argument("--matrix", default="")
    ap.add_argument("--matrix-b", default="")
    ap.add_argument("--solvers", default="")
    ap.add_argument("--select-k", type=int, default=0,
                    help="also sweep the selecting solvers at n_vec=K")
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    try:
        sweep(args)
    finally:
        if torch.distributed.is_available() and \
                torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
