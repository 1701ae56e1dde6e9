#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``eigenkernel_tpu_torch``) on one
CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):

1. Card: require a CUDA device; print ``nvidia-smi``'s name and power limit.
2. Build: compile the hand-written kernels (``eigenkernel_tpu_torch/csrc``)
   with nvcc and print the build time.
3. Kernels against their plain PyTorch versions on the card, at the main
   path's shapes (n = 4096 random tridiagonal, the 500 lowest indices,
   float64 and float32), timed with CUDA events.
4. Main path: the CLI, in process, solves the 500 lowest eigenpairs of a
   sparse symmetric n = 4096 matrix (bandwidth 64 plus random long-range
   couplings, as in the ELSES tight-binding matrices) with
   ``-s scalapack_select``, in float64 and float32; residual,
   orthogonality and eigenvalues against ``torch.linalg.eigvalsh`` must
   meet their bars, and both kernels must have been launched.
5. Full spectrum: ``EK_TRIDIAG=bisect -s scalapack`` at n = 2048, float64.

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_KERNEL, K_KERNEL = 4096, 500
N_MAIN, K_MAIN = 4096, 500
N_FULL = 2048


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    print(f"  {'ok  ' if ok else 'FAIL'} {what}", flush=True)
    if not ok:
        raise SmokeFailure(what)


def elses_like(n: int, seed: int, band: int = 64, long_frac: float = 0.01):
    """Lower-triangle COO of a sparse symmetric matrix in the ELSES style:
    a band of half-width ``band`` (hoppings decaying with distance) plus
    ``long_frac`` of the remaining lower-triangle pairs as weak random
    long-range couplings."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for off in range(band + 1):
        i = np.arange(off, n)
        rows.append(i)
        cols.append(i - off)
        scale = 1.0 if off == 0 else np.exp(-off / 16.0)
        vals.append(rng.standard_normal(i.size) * scale)
    n_pairs = (n - band - 1) * (n - band) // 2
    m = int(long_frac * n_pairs)
    i = rng.integers(band + 1, n, size=m)
    j = (rng.random(m) * (i - band)).astype(np.int64)   # j < i - band
    key = np.unique(i * n + j)
    rows.append(key // n)
    cols.append(key % n)
    vals.append(rng.standard_normal(key.size) * 0.05)
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


def time_ms(fn, reps: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernels(dev):
    """Phase 3: each kernel against its plain version on the card."""
    import numpy as np
    import torch

    from eigenkernel_tpu_torch.ops import sturm, tridiag_solve
    from eigenkernel_tpu_torch.ops.tridiag import (gershgorin_bounds,
                                                   pivot_floor)

    n, k = N_KERNEL, K_KERNEL
    rng = np.random.default_rng(0)
    d_np, e_np = rng.standard_normal(n), rng.standard_normal(n - 1)
    b_np = rng.standard_normal((n, k))
    out = {"sturm": {}, "solve": {}}
    for dtype, iters, solve_tol in ((torch.float64, 62, 1e-10),
                                    (torch.float32, 30, 1e-4)):
        tag = "f64" if dtype == torch.float64 else "f32"
        d = torch.tensor(d_np, dtype=dtype, device=dev)
        e = torch.tensor(e_np, dtype=dtype, device=dev)
        lo, hi = gershgorin_bounds(d, e)
        span = float(hi - lo)
        eps = torch.finfo(dtype).eps
        idx = torch.arange(k, dtype=torch.int32, device=dev)

        def run_kernel():
            return sturm.sturm_bisect(d, e, idx, lo, hi, iters)

        lam = run_kernel()
        torch.cuda.synchronize()
        ms = time_ms(run_kernel, 5)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        lam_plain = sturm.sturm_bisect_plain(d, e, idx, lo, hi, iters)
        t1.record()
        torch.cuda.synchronize()
        plain_ms = t0.elapsed_time(t1)
        err = float((lam - lam_plain).abs().max())
        bar = 2.0 ** -iters * span + 8 * eps * span
        print(f"sturm_bisect {tag}: kernel {ms:.3f} ms, plain "
              f"{plain_ms:.1f} ms, max |dlam| {err:.3e} (bar {bar:.3e})")
        check(err <= bar, f"sturm_bisect {tag} kernel == plain")
        out["sturm"][tag] = {"ms": ms, "plain_ms": plain_ms,
                             "max_abs_err": err}

        shifts = lam + 1e-3 * span
        b = torch.tensor(b_np, dtype=dtype, device=dev)
        tiny = pivot_floor(d, e)       # the floor inverse iteration passes

        def run_solve():
            return tridiag_solve.tridiag_solve(d, e, shifts, b, tiny)

        x = run_solve()
        torch.cuda.synchronize()
        ms = time_ms(run_solve, 10)
        t0.record()
        x_plain = tridiag_solve.tridiag_solve_plain(d, e, shifts, b, tiny)
        t1.record()
        torch.cuda.synchronize()
        plain_ms = t0.elapsed_time(t1)
        xn = x / torch.linalg.vector_norm(x, dim=0)
        pn = x_plain / torch.linalg.vector_norm(x_plain, dim=0)
        # sign-fix each column by its largest entry in the plain solution
        piv = pn.abs().argmax(dim=0, keepdim=True)
        xn = xn * torch.sign(xn.gather(0, piv))
        pn = pn * torch.sign(pn.gather(0, piv))
        err = float((xn - pn).abs().max())
        print(f"tridiag_solve {tag}: kernel {ms:.3f} ms, plain {plain_ms:.1f} "
              f"ms, max |dx| (normalized) {err:.3e} (bar {solve_tol:g})")
        check(bool(torch.isfinite(x).all()) and err <= solve_tol,
              f"tridiag_solve {tag} kernel == plain")
        out["solve"][tag] = {"ms": ms, "plain_ms": plain_ms,
                             "max_abs_err": err}
    return out


def run_cli(workdir: str, argv: list) -> str:
    """Run the port's CLI in process in ``workdir``; returns its stdout."""
    from eigenkernel_tpu_torch import cli

    buf = io.StringIO()
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    finally:
        os.chdir(cwd)
    print(buf.getvalue(), end="")
    check(rc == 0, f"cli {' '.join(argv)} exits 0")
    return buf.getvalue()


def _number(text: str, label: str) -> float:
    m = re.search(re.escape(label) + r"\s*([-+0-9.Ee]+)", text)
    if m is None:
        raise SmokeFailure(f"no '{label}' line in the CLI output")
    return float(m.group(1))


def check_run(workdir, out, a_dev, k, dtype_name, resid_bar, orth_bar,
              ev_rel_bar):
    """Residual, orthogonality and eigenvalues of one CLI run."""
    import numpy as np
    import torch

    resid = _number(out, "residual norm (max):")
    orth = _number(out, "orthogonality criterion:")
    check(resid <= resid_bar, f"{dtype_name} resid max {resid:.3e} <= "
                              f"{resid_bar:g}")
    check(orth <= orth_bar, f"{dtype_name} orthogonality {orth:.3e} <= "
                            f"{orth_bar:g}")
    ev = np.loadtxt(os.path.join(workdir, "eigenvalues.dat"), ndmin=2)
    check(ev.shape == (k, 2) and bool(np.isfinite(ev).all()),
          f"{dtype_name} eigenvalues.dat holds {k} finite values")
    ref = torch.linalg.eigvalsh(a_dev).cpu().numpy()
    norm2 = float(np.abs(ref).max())
    err = float(np.abs(ev[:, 1] - ref[:k]).max())
    check(err <= ev_rel_bar * norm2,
          f"{dtype_name} |eig - eigvalsh| {err:.3e} <= {ev_rel_bar:g} * "
          f"||A||_2 ({norm2:.4g})")
    with open(os.path.join(workdir, "log.json")) as f:
        events = json.load(f)["events"]
    print(f"  stage table ({dtype_name}):")
    for ev_ in events:
        if ev_["name"].startswith(("sep:", "!sep:", "main:eigen_solver")):
            print(f"    {ev_['name']:36s} {ev_['val']:.6f}")


def phase_main(dev, tmp):
    """Phase 4: the CLI's selecting path, float64 and float32."""
    import numpy as np
    import torch

    from eigenkernel_tpu_torch.core.types import SparseMatrix
    from eigenkernel_tpu_torch.io.matrix_market import write_matrix
    from eigenkernel_tpu_torch.ops import sturm, tridiag_solve

    rows, cols, vals = elses_like(N_MAIN, seed=1)
    mat = SparseMatrix(N_MAIN, rows, cols, vals)
    path = os.path.join(tmp, "A4096.mtx")
    write_matrix(path, mat)
    print(f"matrix: n={N_MAIN}, {mat.nnz} lower-triangle entries")
    a_dev = torch.tensor(mat.to_dense(), device=dev)
    sturm.LAUNCHES = tridiag_solve.LAUNCHES = 0
    for dtype_name, bars in (("float64", (1e-12, 1e-10, 1e-10)),
                             ("float32", (1e-5, 1e-3, 1e-4))):
        work = os.path.join(tmp, f"main_{dtype_name}")
        os.makedirs(work)
        out = run_cli(work, ["-s", "scalapack_select", "-n", str(K_MAIN),
                             "-c", str(K_MAIN), "-t", f"1,{K_MAIN}",
                             "--dtype", dtype_name, path])
        check_run(work, out, a_dev, K_MAIN, dtype_name, *bars)
    launches = {"sturm": sturm.LAUNCHES, "solve": tridiag_solve.LAUNCHES}
    print(f"launches on the main path: {launches}")
    check(launches["sturm"] > 0 and launches["solve"] > 0,
          "both kernels launched on the main path")
    return launches


def phase_full(dev, tmp):
    """Phase 5: full spectrum through the bisection core."""
    import torch

    from eigenkernel_tpu_torch.core.types import SparseMatrix
    from eigenkernel_tpu_torch.io.matrix_market import write_matrix
    from eigenkernel_tpu_torch.ops import sturm, tridiag_solve

    rows, cols, vals = elses_like(N_FULL, seed=2)
    mat = SparseMatrix(N_FULL, rows, cols, vals)
    path = os.path.join(tmp, "A2048.mtx")
    write_matrix(path, mat)
    a_dev = torch.tensor(mat.to_dense(), device=dev)
    work = os.path.join(tmp, "full")
    os.makedirs(work)
    before = (sturm.LAUNCHES, tridiag_solve.LAUNCHES)
    os.environ["EK_TRIDIAG"] = "bisect"
    try:
        out = run_cli(work, ["-s", "scalapack", "-c", "-1",
                             "-t", f"1,{N_FULL}", path])
    finally:
        del os.environ["EK_TRIDIAG"]
    check(sturm.LAUNCHES > before[0] and tridiag_solve.LAUNCHES > before[1],
          "both kernels launched on the full-spectrum path")
    check_run(work, out, a_dev, N_FULL, "float64 full", 1e-12, 1e-10, 1e-10)


def main() -> int:
    import torch

    # phase 1: card
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    sys.path.insert(0, ROOT)
    from eigenkernel_tpu_torch.core.config import set_matmul_precision_highest
    from eigenkernel_tpu_torch.ops import build

    set_matmul_precision_highest()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # phase 2: build
    t0 = time.time()
    build.library()
    print(f"build: {time.time() - t0:.1f} s (nvcc {build.BUILD_SECONDS:.1f} s)")
    for line in build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    # phase 3: kernels against their plain versions
    kern = phase_kernels(dev)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        launches = phase_main(dev, tmp)
        print(f"main path: {time.time() - t0:.1f} s")
        t0 = time.time()
        phase_full(dev, tmp)
        print(f"full spectrum: {time.time() - t0:.1f} s")

    entries = []
    for key, name, src, replaces in (
            ("sturm", "sturm_bisect_kernel",
             "eigenkernel_tpu_torch/csrc/sturm_bisect.cu",
             "eigenkernel_tpu/ops/pallas_sturm.py:78"),
            ("solve", "tridiag_solve_kernel",
             "eigenkernel_tpu_torch/csrc/tridiag_solve.cu",
             "eigenkernel_tpu/ops/pallas_solve.py:114")):
        f64, f32 = kern[key]["f64"], kern[key]["f32"]
        entries.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[key],
                        "max_abs_err": f64["max_abs_err"], "ms": f64["ms"],
                        "plain_ms": f64["plain_ms"], "float32": f32})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
