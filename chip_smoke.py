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
   float64 and float32), timed with CUDA events: B1 (Sturm bisection) and
   B2 (the shifted tridiagonal solve) must equal them bit for bit.  B1 is
   also timed at 1 and 2 warps a target (trees of depth 5 and 6 a pass)
   for 4, 500 and 4096 targets, with its time per pass and per row step,
   and beside one float64 ``torch.linalg.eigvalsh`` of the densified
   tridiagonal (its library time; the port never calls it).
4. Main path: the CLI, in process, solves the 500 lowest eigenpairs of a
   sparse symmetric n = 4096 matrix (bandwidth 64 plus random long-range
   couplings, as in the ELSES tight-binding matrices) with
   ``-s scalapack_select``, in float64 and float32; residual,
   orthogonality and eigenvalues against ``torch.linalg.eigvalsh`` must
   meet their bars, and both kernels must have been launched.  The
   float64 solve then runs once more (outside the launch count), so that
   its stage table shows what the first solve of the process paid to
   start cuBLAS and cuSOLVER.
5. Full spectrum: ``EK_TRIDIAG=bisect -s scalapack`` at n = 2048, float64.
6. The two-stage kernels against their plain versions on the card: the
   bulge chase (B3) on the band of a random symmetric n = 4096 matrix at
   the default bandwidth 64 (d, e, the reflectors, the spectrum, and
   ``Q2 tridiag(d, e) Q2^T`` against the band), and both chase
   back-transforms (B4, B5) on its reflectors with z of 500 columns,
   float64 and float32; B5 with its plan (g, tile width, CTAs, µs a block)
   and also at g = 16, 32 and 64.
7. Two-stage selecting path at its real size: the CLI runs
   ``EK_SELECT_CORE=two_stage -s scalapack_select`` for the 500 lowest
   eigenpairs of an ELSES-style n = 16384 matrix, float64 and float32,
   against one float64 ``torch.linalg.eigvalsh`` of the matrix; B3 and B4
   must have been launched.  B1, B2 and B4 are then held against their
   plain versions on the operands the path gave them (recorded during the
   run): B1 and B2 bit for bit, timed; B4 whole and phase by phase (the
   stream build, the kernel and the per-step ``torch.bmm``, each timed
   apart); B5 on B4's operands, beside B4's whole call; and, in float64,
   B3 against its plain version on the band of that matrix.
8. Full spectrum through the two-stage core: ``EK_TRIDIAG=bisect -s
   eigensx`` at n = 4096, float64 (B4 at k = n, then held against its plain
   version on the path's operands, whole and phase by phase).
9. The WY-block back-transform (B5) on the path: ``EK_BACKTRANSFORM=pallas``
   with ``-s eigensx`` at n = 2048, float64; B5 must have been launched,
   and is then held against its plain version on the path's operands
   (and timed beside B4's whole plain version, its library call).
10. Full spectrum through divide and conquer: the CLI runs ``-s
    scalapack`` at n = 4096, float64 and float32, with ``EK_TRIDIAG``
    unset, then ``-s lapack`` and ``-s eigensx`` (float64), each against
    the bars of phase 4; D1 (the deflation scans, ``csrc/dc_deflate.cu``)
    must have been launched once a tree level.  D1 is then held against
    its plain version (``torch.equal`` on every record) on the operands
    each level of the scalapack runs gave it, timed with CUDA events
    beside its bound (the level's most close steps in a merge times the
    step latency from ``tools/div_chain.py``, run in phase 2, or its
    bytes) and its share of close steps; the whole ``tridiag_dc`` is
    timed beside one ``torch.linalg.eigh`` of T, and one run of it a dtype
    is traced with torch.profiler (kernels, D1's device time).
11. Generalized problems at n = 4096: an ELSES-style A and an SPD overlap
    B of the same sparsity; ``general_scalapacknew_eigens`` (float64,
    float32), ``general_elpa2`` and ``general_scalapack_select -n 500``
    (float64), by the B-metric residual and orthogonality of the port's
    verifier and against eigenvalues the smoke forms from its own float64
    Cholesky of B; each path's kernels must have been launched.
12. The extra cores and ``--dtype mixed`` at n = 4096, on a new ELSES-style
    matrix (seed 10) against the bars of phase 4: ``-s jacobi`` float64
    and float32 (D2, the batched pair eigh ``csrc/pair_jacobi.cu``, must
    have been launched once a round: 63 rounds x 12 / 8 sweeps), ``-s
    qdwh_dc`` float64, and ``--dtype mixed`` with ``-s scalapack`` (then a
    float64 ``scalapack`` solve of the same matrix, for the time),
    ``-s scalapack_select -n 500`` and, on phase 11's A and B,
    ``general_elpa2``, held to the float64 bars (a part of the spectrum is
    refined only inside the span of its float32 vectors, so the selecting
    run's residual is held to the float32 bar, its eigenvalues and
    orthogonality to the float64 ones); ``general_jacobi`` and
    ``general_qdwh_dc`` (float64) on phase 11's A and B.  Each run prints
    its stage table and peak memory; the mixed ``scalapack`` run's float32
    vectors are refined again at 4 to 12 Newton steps, each one's residual
    printed, and one float64 ``block_jacobi_eigh`` of that run is traced
    with torch.profiler (D2's, the products' and the gathers' device
    time).  D2 is then held against its plain
    version (``torch.equal`` on values, vectors, sweeps and rotations) on
    the pair blocks the float64 ``jacobi`` run gave it in its first and
    last round and on a random (32, 128, 128) batch, each timed with CUDA
    events beside its bound (``obs/flops.py::bound_pair_eigh``, the set
    latency from ``tools/div_chain.py``) and one ``torch.linalg.eigh`` of
    the same batch (its library call); also D2 and that call on the
    (64, 64, 64) batch of tridiagonal blocks of divide and conquer's
    leaves at n = 4096.  Beside each D2 comparison,
    ``tools/pair_jacobi_profile.py`` prints D2's cycles a set by phase
    (an instrumented build, held equal to D2 bit for bit), and the smoke
    prints the time D2's first design took on the same operands
    (``FIRST_DESIGN_MS``).

Every main path starts with every launch count at 0 and reads the counts
right after; the kernel comparisons of phases 3, 6 and those after each
path do not count.  The second-to-last line is a JSON object with one
entry per kernel: its time, its plain version's, its bound
(``eigenkernel_tpu_torch/obs/flops.py``: the larger of its operations
over the card's peak and its bytes over the memory rate, with what bounds
it) and the time of one PyTorch call of the same function where there is
one (``library_ms``: ``eigvalsh`` for B1, the per-step ``torch.bmm`` for
B4, B4's whole plain version (P stream and ``torch.bmm``) for B5,
``torch.linalg.eigh`` of the batch for D2; null for B2, B3 and D1), in
float64 at the shape named in the entry; the last line is ``{"ok": true,
"device": {...}}``.
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
N_TWO, K_TWO = 16384, 500      # the ROADMAP's selecting target
N_SX = 4096                    # eigensx, full spectrum
N_B5 = 2048                    # eigensx under EK_BACKTRANSFORM=pallas
N_DC = 4096                    # full spectrum through divide and conquer
N_GEN, K_GEN = 4096, 500       # generalized problems
N_X, K_X = 4096, 500           # the extra cores and --dtype mixed
# D2's first design (one CTA a block: rows, then columns and V^T; kept in
# tools/pair_jacobi_rowcol.cu) on the operands of phase 12's comparisons,
# ms by CUDA events, from this script's run on an NVIDIA H100 80GB HBM3,
# 700.00 W before the redesign (printed beside D2's time)
FIRST_DESIGN_MS = {("f64", "path round 1"): 10.995,
                   ("f64", "path round 756"): 0.716,
                   ("f64", "random"): 11.073, ("f64", "dc leaves"): 1.513,
                   ("f32", "random"): 7.982, ("f32", "dc leaves"): 1.164}


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


@contextlib.contextmanager
def env(**values):
    """Set environment variables for the duration of the block."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def capture_ends(module, name):
    """Record the positional arguments of the first and the last call of
    ``module.name`` made inside the block, and the number of calls; the
    calls themselves run unchanged."""
    seen = {"calls": 0}
    fn = getattr(module, name)

    def recording(*args, **kwargs):
        seen["first" if seen["calls"] == 0 else "last"] = args
        seen["calls"] += 1
        return fn(*args, **kwargs)

    setattr(module, name, recording)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def capture(module, name, limit=None):
    """Record the positional arguments of every call of ``module.name``
    made inside the block (of the first ``limit`` calls, if given); the
    calls themselves run unchanged."""
    calls = []
    fn = getattr(module, name)

    def recording(*args, **kwargs):
        if limit is None or len(calls) < limit:
            calls.append(args)
        return fn(*args, **kwargs)

    setattr(module, name, recording)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def reset_launches():
    from eigenkernel_tpu_torch.ops import (backtransform, chase, dc, jacobi,
                                           sturm, tridiag_solve, wf_bt)

    for mod in (sturm, tridiag_solve, chase, wf_bt, backtransform, dc,
                jacobi):
        mod.LAUNCHES = 0


def read_launches() -> dict:
    from eigenkernel_tpu_torch.ops import (backtransform, chase, dc, jacobi,
                                           sturm, tridiag_solve, wf_bt)

    return {"sturm": sturm.LAUNCHES, "solve": tridiag_solve.LAUNCHES,
            "chase": chase.LAUNCHES, "wf_bt": wf_bt.LAUNCHES,
            "chase_bt": backtransform.LAUNCHES, "deflate": dc.LAUNCHES,
            "pair_eigh": jacobi.LAUNCHES}


def time_ms(fn, reps: int, batches: int = 5) -> float:
    """Milliseconds a call of ``fn``: the median over ``batches`` batches
    of ``reps`` calls each, timed with CUDA events."""
    import statistics

    import torch

    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def sm_clock_mhz() -> float:
    """The SM clock ``nvidia-smi`` reads now, in MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True,
        timeout=60).stdout
    return float(out.split()[0])


def sturm_passes(iters: int, warps: int) -> int:
    """B1's passes over the rows at ``warps`` warps a target."""
    from eigenkernel_tpu_torch.ops import sturm

    return len(sturm.round_depths(iters, sturm.depth_of(warps)))


def compare_sturm(d, e, idx, lo, hi, iters, reps, label):
    """B1 on these operands against its plain version, bit for bit; its
    time, per pass of the rows and per dependent row step."""
    import torch

    from eigenkernel_tpu_torch.ops import sturm

    tag = "f64" if d.dtype == torch.float64 else "f32"
    n, k = d.shape[0], idx.shape[0]
    warps = sturm.warps_per_target(
        k, torch.cuda.get_device_properties(d.device).multi_processor_count)

    def run():
        return sturm.sturm_bisect(d, e, idx, lo, hi, iters)

    lam = run()
    torch.cuda.synchronize()
    ms = time_ms(run, reps)
    mhz = sm_clock_mhz()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    lam_plain = sturm.sturm_bisect_plain(d, e, idx, lo, hi, iters)
    t1.record()
    torch.cuda.synchronize()
    plain_ms = t0.elapsed_time(t1)
    err = float((lam - lam_plain).abs().max())
    passes = sturm_passes(iters, warps)
    ns_step = 1e6 * ms / (passes * n)
    print(f"sturm_bisect {tag} {label}: n={n} k={k} iters={iters}, "
          f"{warps} warps a target, {passes} passes: kernel {ms:.3f} ms "
          f"({1e3 * ms / passes:.1f} us a pass, {ns_step:.2f} ns = "
          f"{ns_step * mhz / 1e3:.1f} cycles at {mhz:.0f} MHz a row step), "
          f"plain {plain_ms:.1f} ms, max |dlam| {err:.3e} (bar: equal)")
    check(torch.equal(lam, lam_plain),
          f"sturm_bisect {tag} {label} kernel == plain bit for bit")
    return lam, {"n": n, "k": k, "iters": iters, "dtype": tag, "ms": ms,
                 "plain_ms": plain_ms, "max_abs_err": err, "passes": passes,
                 "warps": warps, "ns_per_step": ns_step,
                 "sm_mhz": mhz}


def eigvalsh_ms(d, e):
    """The library call for B1's function: one float64
    ``torch.linalg.eigvalsh`` of the densified tridiagonal (every
    eigenvalue), after a warm-up call; the port never calls it."""
    import torch

    tri = torch.diag(d.double()) + torch.diag(e.double(), 1) \
        + torch.diag(e.double(), -1)
    torch.linalg.eigvalsh(tri)
    torch.cuda.synchronize()
    ms = time_ms(lambda: torch.linalg.eigvalsh(tri), 1, batches=1)
    print(f"library: torch.linalg.eigvalsh of T, n={d.shape[0]}: "
          f"{ms:.3f} ms")
    del tri
    torch.cuda.empty_cache()
    return ms


def compare_solve(d, e, lam, b, tiny, reps, label):
    """B2 on these operands against its plain version, bit for bit."""
    import torch

    from eigenkernel_tpu_torch.ops import tridiag_solve

    tag = "f64" if d.dtype == torch.float64 else "f32"
    n, k = b.shape

    def run():
        return tridiag_solve.tridiag_solve(d, e, lam, b, tiny)

    x = run()
    torch.cuda.synchronize()
    ms = time_ms(run, reps)
    mhz = sm_clock_mhz()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    x_plain = tridiag_solve.tridiag_solve_plain(d, e, lam, b, tiny)
    t1.record()
    torch.cuda.synchronize()
    plain_ms = t0.elapsed_time(t1)
    err = float((x - x_plain).abs().max())
    ns_row = 1e6 * ms / (2 * n)
    print(f"tridiag_solve {tag} {label}: n={n} k={k}, kernel {ms:.3f} ms "
          f"({ns_row:.2f} ns = {ns_row * mhz / 1e3:.1f} cycles at {mhz:.0f} "
          f"MHz a row of either sweep), plain {plain_ms:.1f} ms, max |dx| "
          f"{err:.3e} (bar: equal)")
    check(bool(torch.isfinite(x).all()) and torch.equal(x, x_plain),
          f"tridiag_solve {tag} {label} kernel == plain bit for bit")
    return {"n": n, "k": k, "dtype": tag, "ms": ms, "plain_ms": plain_ms,
            "max_abs_err": err, "ns_per_row": ns_row, "sm_mhz": mhz}


def phase_kernels(dev):
    """Phase 3: each kernel against its plain version on the card."""
    import numpy as np
    import torch

    from eigenkernel_tpu_torch.ops import sturm
    from eigenkernel_tpu_torch.ops.tridiag import (gershgorin_bounds,
                                                   pivot_floor)

    n, k = N_KERNEL, K_KERNEL
    rng = np.random.default_rng(0)
    d_np, e_np = rng.standard_normal(n), rng.standard_normal(n - 1)
    b_np = rng.standard_normal((n, k))
    out = {"sturm": {}, "solve": {}}
    for dtype, iters in ((torch.float64, 62), (torch.float32, 30)):
        tag = "f64" if dtype == torch.float64 else "f32"
        d = torch.tensor(d_np, dtype=dtype, device=dev)
        e = torch.tensor(e_np, dtype=dtype, device=dev)
        lo, hi = gershgorin_bounds(d, e)
        span = float(hi - lo)
        idx = torch.arange(k, dtype=torch.int32, device=dev)
        lam, out["sturm"][tag] = compare_sturm(d, e, idx, lo, hi, iters, 5,
                                               "random T")
        # the tree depth a pass covers, 1 or 2 warps a target, for few,
        # the path's and as many targets as rows: the lowest 500 the same
        # bits as the plain version, either depth the same bits as the
        # other
        by_warps = {}
        for kk in (4, k, n):
            ii = torch.arange(kk, dtype=torch.int32, device=dev)
            got = {w: sturm._launch(d, e, ii, lo, hi, iters, w)
                   for w in (1, sturm.MAX_WARPS)}
            check(torch.equal(got[1], got[sturm.MAX_WARPS])
                  and torch.equal(got[1][:k], lam[:kk]),
                  f"sturm_bisect {tag} k={kk} at 1 and {sturm.MAX_WARPS} "
                  f"warps a target == plain")
            for w in got:
                ms = time_ms(lambda: sturm._launch(d, e, ii, lo, hi, iters,
                                                   w), 5)
                by_warps[f"k={kk} warps={w}"] = ms
                ns_step = 1e6 * ms / (sturm_passes(iters, w) * n)
                print(f"sturm_bisect {tag} k={kk}, {w} warps a target: "
                      f"{ms:.3f} ms ({ns_step:.2f} ns = "
                      f"{ns_step * out['sturm'][tag]['sm_mhz'] / 1e3:.1f} "
                      f"cycles a row step)")
        out["sturm"][tag]["ms_by_warps"] = by_warps
        if dtype == torch.float64:
            # the library call for B1's function: every eigenvalue of the
            # densified T (the port never calls it)
            tri = torch.diag(d) + torch.diag(e, 1) + torch.diag(e, -1)
            torch.linalg.eigvalsh(tri)
            torch.cuda.synchronize()
            lib_ms = time_ms(lambda: torch.linalg.eigvalsh(tri), 3)
            print(f"library: torch.linalg.eigvalsh of T, n={n}: "
                  f"{lib_ms:.3f} ms")
            out["sturm"][tag]["library_ms"] = lib_ms
            del tri

        shifts = lam + 1e-3 * span
        b = torch.tensor(b_np, dtype=dtype, device=dev)
        tiny = pivot_floor(d, e)       # the floor inverse iteration passes
        out["solve"][tag] = compare_solve(d, e, shifts, b, tiny, 10,
                                          "random T")
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


def check_run(workdir, out, ref, k, dtype_name, resid_bar, orth_bar,
              ev_rel_bar):
    """Residual, orthogonality and eigenvalues (against ``ref``, the
    ascending eigenvalues of the matrix) of one CLI run."""
    import numpy as np

    resid = _number(out, "residual norm (max):")
    orth = _number(out, "orthogonality criterion:")
    check(resid <= resid_bar, f"{dtype_name} resid max {resid:.3e} <= "
                              f"{resid_bar:g}")
    check(orth <= orth_bar, f"{dtype_name} orthogonality {orth:.3e} <= "
                            f"{orth_bar:g}")
    ev = np.loadtxt(os.path.join(workdir, "eigenvalues.dat"), ndmin=2)
    check(ev.shape == (k, 2) and bool(np.isfinite(ev).all()),
          f"{dtype_name} eigenvalues.dat holds {k} finite values")
    norm2 = float(np.abs(ref).max())
    err = float(np.abs(ev[:, 1] - ref[:k]).max())
    check(err <= ev_rel_bar * norm2,
          f"{dtype_name} |eig - eigvalsh| {err:.3e} <= {ev_rel_bar:g} * "
          f"||A||_2 ({norm2:.4g})")
    with open(os.path.join(workdir, "log.json")) as f:
        events = json.load(f)["events"]
    print(f"  stage table ({dtype_name}):")
    for ev_ in events:
        if ev_["name"].lstrip("!").startswith(
                ("sep:", "solve:", "reduce_", "recovery_",
                 "main:eigen_solver")):
            print(f"    {ev_['name']:36s} {ev_['val']:.6f}")
    return {e_["name"]: e_["val"] for e_ in events}


def phase_main(dev, tmp):
    """Phase 4: the CLI's selecting path, float64 and float32."""
    mat, path = write_elses(tmp, N_MAIN, seed=1)
    ref = reference_eigvalsh(mat, dev)
    reset_launches()
    for dtype_name, bars in (("float64", (1e-12, 1e-10, 1e-10)),
                             ("float32", (1e-5, 1e-3, 1e-4))):
        work = os.path.join(tmp, f"main_{dtype_name}")
        os.makedirs(work)
        out = run_cli(work, ["-s", "scalapack_select", "-n", str(K_MAIN),
                             "-c", str(K_MAIN), "-t", f"1,{K_MAIN}",
                             "--dtype", dtype_name, path])
        check_run(work, out, ref, K_MAIN, dtype_name, *bars)
    launches = read_launches()
    print(f"launches on the main path: {launches}")
    check(launches["sturm"] > 0 and launches["solve"] > 0,
          "both kernels launched on the main path")
    # the float64 solve again: the first one of the process also started
    # cuBLAS and cuSOLVER
    work = os.path.join(tmp, "main_float64_again")
    os.makedirs(work)
    out = run_cli(work, ["-s", "scalapack_select", "-n", str(K_MAIN),
                         "-c", str(K_MAIN), "-t", f"1,{K_MAIN}",
                         "--dtype", "float64", path])
    check_run(work, out, ref, K_MAIN, "float64 again", 1e-12, 1e-10, 1e-10)
    return launches


def reference_eigvalsh(mat, dev):
    """Ascending eigenvalues of ``mat`` by one float64
    ``torch.linalg.eigvalsh`` on the card."""
    import torch

    a_dev = torch.tensor(mat.to_dense(), device=dev)
    torch.cuda.synchronize()
    t0 = time.time()
    ref = torch.linalg.eigvalsh(a_dev).cpu().numpy()
    print(f"reference eigvalsh n={mat.size}: {time.time() - t0:.1f} s")
    del a_dev
    torch.cuda.empty_cache()
    return ref


def write_elses(tmp, n, seed):
    from eigenkernel_tpu_torch.core.types import SparseMatrix
    from eigenkernel_tpu_torch.io.matrix_market import write_matrix

    rows, cols, vals = elses_like(n, seed=seed)
    mat = SparseMatrix(n, rows, cols, vals)
    path = os.path.join(tmp, f"A{n}_{seed}.mtx")
    write_matrix(path, mat)
    print(f"matrix: n={n}, {mat.nnz} lower-triangle entries, seed {seed}")
    return mat, path


def phase_full(dev, tmp):
    """Phase 5: full spectrum through the bisection core."""
    mat, path = write_elses(tmp, N_FULL, seed=2)
    ref = reference_eigvalsh(mat, dev)
    work = os.path.join(tmp, "full")
    os.makedirs(work)
    reset_launches()
    with env(EK_TRIDIAG="bisect"):
        out = run_cli(work, ["-s", "scalapack", "-c", "-1",
                             "-t", f"1,{N_FULL}", path])
    launches = read_launches()
    check(launches["sturm"] > 0 and launches["solve"] > 0,
          "both kernels launched on the full-spectrum path")
    check_run(work, out, ref, N_FULL, "float64 full", 1e-12, 1e-10, 1e-10)
    return mat, path, ref


def first_divergence(res, plain, bar=1e-3):
    """Where the kernel's and the plain version's reflectors part: the
    first chase step (4c + t for sweep c, position t) at which one of them
    differs by more than ``bar``, or None.  ``1 - tau = alpha / beta`` with
    ``|beta| = ||x||``, so ``|1 - tau|`` there is the pivot's share
    ``|alpha| / ||x||`` of its column; ``flip_residual``, the largest
    ``|v + v_plain|`` over the tail, is small where the two pivots took
    opposite signs (``v_tail = x_tail / (alpha - beta)``)."""
    import torch

    diff = torch.maximum((res.HV - plain.HV).abs().amax(2),
                         (res.HT - plain.HT).abs())              # (n, T)
    n, T = diff.shape
    step = (4 * torch.arange(n, device=diff.device)[:, None]
            + torch.arange(T, device=diff.device)[None, :])
    bad = diff > bar
    if not bool(bad.any()):
        return None
    s0 = int(step[bad].min())
    c, t = (int(x) for x in torch.nonzero(bad & (step == s0))[0])
    before = diff[step < s0]
    return {"step": s0, "sweep": c, "position": t,
            "max_diff_before": float(before.max()) if before.numel() else 0.0,
            "diff": float(diff[c, t]), "tau": float(res.HT[c, t]),
            "tau_plain": float(plain.HT[c, t]),
            "pivot_share": abs(1.0 - float(plain.HT[c, t])),
            "flip_residual": float((res.HV[c, t, 1:]
                                    + plain.HV[c, t, 1:]).abs().max())}


def compare_chase(band_m, bw, lam_ref, tag, reps, recon):
    """B3 against its plain version on ``band_m``: d and e, the reflectors
    (float64), the spectrum against ``lam_ref`` (ascending eigenvalues of
    the band) and each other, and with ``recon`` ``Q2 tridiag(d, e) Q2^T``
    against the band (Q2 from the kernel's reflectors by the plain
    back-transform).  Returns the kernel result and the numbers."""
    import numpy as np
    import scipy.linalg as sla
    import torch

    from eigenkernel_tpu_torch.obs import flops
    from eigenkernel_tpu_torch.ops import bulge, chase

    n = band_m.shape[0]
    f64 = band_m.dtype == torch.float64
    res = chase.band_to_tridiag(band_m, bw)
    torch.cuda.synchronize()
    ms = time_ms(lambda: chase.band_to_tridiag(band_m, bw), reps)
    t0 = time.time()
    plain = chase.band_to_tridiag_plain(band_m, bw)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.time() - t0)
    scale = float(np.abs(lam_ref).max())
    err = max(float((res.d - plain.d).abs().max()),
              float((res.e - plain.e).abs().max()))
    hv_err = float((res.HV - plain.HV).abs().max())
    ht_err = float((res.HT - plain.HT).abs().max())

    def spectrum(r):
        return sla.eigvalsh_tridiagonal(r.d.double().cpu().numpy(),
                                        r.e.double().cpu().numpy())

    lam_k = spectrum(res)
    sp_ref = float(np.abs(lam_k - lam_ref).max()) / scale
    sp_plain = float(np.abs(lam_k - spectrum(plain)).max()) / scale
    steps = chase.n_steps(n, bw)
    bound_ms, bound_by = flops.bound_chase(n, bw, band_m.dtype)
    print(f"band_chase {tag}: n={n} bw={bw}, {steps} steps in one launch "
          f"({chase.BRANCH} branch, {chase.GRID} CTAs), kernel {ms:.3f} ms "
          f"({1e3 * ms / steps:.3f} us per step; bound {bound_ms:.3f} ms, "
          f"{bound_by}), plain {plain_ms:.1f} ms, max |d, e - plain| "
          f"{err:.3e}, |HV - plain| {hv_err:.3e}, |HT - plain| {ht_err:.3e}, "
          f"spectrum vs eigvalsh {sp_ref:.3e}, vs plain {sp_plain:.3e} "
          f"(relative to ||band||_2 {scale:.4g})")
    div = first_divergence(res, plain)
    print(f"  reflectors first part by > 1e-3 at: {div}")
    bar = 1e-12 if f64 else 5e-5     # the float32 bar: test_pallas_kernels
    check(sp_ref <= bar and sp_plain <= bar,
          f"band_chase {tag} spectrum == eigvalsh == plain (bar {bar:g})")
    if f64:
        # rounding order differs (FMA contraction, summation), so d, e and
        # the reflectors drift apart along the chase: |v| <= 1 and tau is 0
        # or in [1, 2], and the drift reaches 2e-10 at n = 4096 and 2e-8 at
        # n = 16384, while a wrong reflector differs by O(1)
        check(err <= 1e-8 * scale and hv_err <= 1e-6 and ht_err <= 1e-6,
              f"band_chase {tag} d, e, HV, HT == plain")
    out = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
           "hv_err": hv_err, "ht_err": ht_err, "spectrum_rel_err": sp_ref,
           "first_divergence": div, "branch": chase.BRANCH,
           "grid": chase.GRID, "us_per_step": 1e3 * ms / steps,
           "bound_ms": bound_ms, "bound_by": bound_by}
    if recon:
        # the reflectors reduce the band to tridiag(d, e): band = Q2 T Q2^T
        q2 = bulge.apply_chase_q(
            res, torch.eye(n, dtype=band_m.dtype, device=band_m.device))
        tri = (torch.diag(res.d) + torch.diag(res.e, 1)
               + torch.diag(res.e, -1))
        rec = float((q2 @ tri @ q2.T - band_m).abs().max()) / scale
        print(f"  max |Q2 T Q2^T - band| / ||band||_2 = {rec:.3e} "
              f"(bar {bar:g})")
        check(rec <= bar, f"band_chase {tag} reflectors reproduce the band")
        out["reconstruction_rel_err"] = rec
        del q2, tri
    return res, out


def compare_bt(name, run, run_plain, res, z, reps=1):
    """A chase back-transform (``run``) against its plain version on
    ``(res, z)``, the bars of tests/test_bt_blocked.py."""
    import torch

    tag = "f64" if z.dtype == torch.float64 else "f32"
    got = run(res, z)
    torch.cuda.synchronize()
    ms = time_ms(lambda: run(res, z), reps)
    t0 = time.time()
    ref = run_plain(res, z)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.time() - t0)
    bar = 1e-12 if tag == "f64" else 5e-6
    zs = float(ref.abs().max())
    err = float((got - ref).abs().max())
    n, k = z.shape
    print(f"{name} {tag}: n={n} k={k}, kernel {ms:.3f} ms, plain "
          f"{plain_ms:.1f} ms, max |dz| {err:.3e} (bar {bar:g} * {zs:.3g})")
    check(bool(torch.isfinite(got).all()) and err <= bar * zs,
          f"{name} {tag} n={n} k={k} kernel == plain")
    return {"n": n, "k": k, "dtype": tag, "ms": ms, "plain_ms": plain_ms,
            "max_abs_err": err}


def compare_chase_bt(res, z, label, reps=1, groups=()):
    """B5 on ``(res, z)`` against its plain version (the bars of
    compare_bt), with its plan: g, tile width, CTAs, blocks, µs a block
    and its bound; with ``groups``, also at each g there (the private
    launcher), each held at the same bar."""
    import torch

    from eigenkernel_tpu_torch.obs import flops
    from eigenkernel_tpu_torch.ops import backtransform, bulge

    tag = "f64" if z.dtype == torch.float64 else "f32"
    n, k = z.shape
    bar = 1e-12 if tag == "f64" else 5e-6
    t0 = time.time()
    ref = bulge.apply_chase_q(res, z)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.time() - t0)
    zs = float(ref.abs().max())
    bound_ms, bound_by = flops.bound_chase_bt(n, k, res.HV.shape[2], z.dtype)
    sms = torch.cuda.get_device_properties(z.device).multi_processor_count
    runs = [(backtransform.GROUP, backtransform.apply_chase_q_sweeps)]
    runs += [(g, lambda r, zz, g=g: backtransform._launch(r, zz, g))
             for g in groups]
    out = {"n": n, "k": k, "dtype": tag, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "by_group": {}}
    for i, (group, fn) in enumerate(runs):
        got = fn(res, z)
        torch.cuda.synchronize()
        pl = backtransform.plan_of(n, res.HV.shape[2], res.HV.shape[1], k,
                                   z.element_size(), group, 0, sms)
        ms = time_ms(lambda: fn(res, z), reps)
        err = float((got - ref).abs().max())
        print(f"chase_bt {tag}{label} g={pl.g}: n={n} k={k}, tile {pl.nc} "
              f"columns, {pl.ctas} CTAs, {pl.blocks} blocks: kernel "
              f"{ms:.3f} ms ({1e3 * ms / pl.blocks:.3f} us a block), plain "
              f"{plain_ms:.1f} ms, bound {bound_ms:.3f} ms ({bound_by}), "
              f"max |dz| {err:.3e} (bar {bar:g} * {zs:.3g})")
        check(bool(torch.isfinite(got).all()) and err <= bar * zs,
              f"chase_bt {tag} g={pl.g} n={n} k={k} kernel == plain")
        row = {"ms": ms, "max_abs_err": err, "g": pl.g, "tile": pl.nc,
               "ctas": pl.ctas, "blocks": pl.blocks,
               "us_per_block": 1e3 * ms / pl.blocks}
        if i == 0:
            out.update(row)
        else:
            out["by_group"][str(pl.g)] = row
        del got
    return out


def compare_wf_bt_phases(res, z, tag_extra=""):
    """B4 on ``(res, z)`` phase by phase: the stream build, the kernel and
    the per-step ``torch.bmm`` loop (the plain version, which is also the
    library call), each timed with CUDA events on every phase; the z
    frames they leave are held against each other (the bars of
    tests/test_bt_blocked.py)."""
    import torch

    from eigenkernel_tpu_torch.obs import flops
    from eigenkernel_tpu_torch.ops import wf_bt

    tag = "f64" if z.dtype == torch.float64 else "f32"
    n, k = z.shape
    pl = wf_bt.plan(res, z)
    zk = wf_bt.frame(z, pl)
    zb = zk.clone()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    stream_ms = kernel_ms = bmm_ms = 0.0
    phases = wf_bt.stream_phases(res, pl)
    for _ in range(pl.nph):
        ev[0].record()
        P, u0 = next(phases)
        ev[1].record()
        wf_bt.apply_phase(P, zk, pl, u0)
        ev[2].record()
        wf_bt.apply_phase_plain(P, zb, pl, u0)
        ev[3].record()
        torch.cuda.synchronize()
        stream_ms += ev[0].elapsed_time(ev[1])
        kernel_ms += ev[1].elapsed_time(ev[2])
        bmm_ms += ev[2].elapsed_time(ev[3])
        del P
    bar = 1e-12 if tag == "f64" else 5e-6
    zs = float(zb.abs().max())
    err = float((zk - zb).abs().max())
    bound_ms, bound_by, launches, steps = flops.bound_wf_bt(
        n, k, pl.b, pl.g, z.dtype)
    print(f"wf_bt {tag}{tag_extra}: n={n} k={k} g={pl.g} m={pl.m}, {pl.nph} "
          f"phases, {launches} launches, {steps} lane-steps: kernel "
          f"{kernel_ms:.3f} ms, per-step bmm {bmm_ms:.3f} ms, stream build "
          f"{stream_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), "
          f"max |dz| {err:.3e} (bar {bar:g} * {zs:.3g})")
    check(bool(torch.isfinite(zk).all()) and err <= bar * zs,
          f"wf_bt {tag} n={n} k={k} kernel == per-step bmm")
    return {"n": n, "k": k, "dtype": tag, "ms": kernel_ms,
            "plain_ms": bmm_ms, "library_ms": bmm_ms,
            "stream_ms": stream_ms, "max_abs_err": err,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_twostage_kernels(dev):
    """Phase 6: B3, B4 and B5 against their plain versions on the card."""
    import numpy as np
    import torch

    from eigenkernel_tpu_torch.core.config import DEFAULT_BLOCK_SIZE
    from eigenkernel_tpu_torch.ops import band, wf_bt

    n, k, bw = N_KERNEL, K_KERNEL, DEFAULT_BLOCK_SIZE
    rng = np.random.default_rng(4)
    a_np = rng.standard_normal((n, n))
    a_np = (a_np + a_np.T) / 2
    z_np = rng.standard_normal((n, k))
    out = {"chase": {}, "wf_bt": {}, "chase_bt": {}}
    for dtype, tag in ((torch.float64, "f64"), (torch.float32, "f32")):
        band_m = band.to_band(torch.tensor(a_np, dtype=dtype, device=dev),
                              bw).band
        lam_band = torch.linalg.eigvalsh(band_m.double()).cpu().numpy()
        res, out["chase"][tag] = compare_chase(band_m, bw, lam_band, tag,
                                               reps=3, recon=True)

        z = torch.tensor(z_np, dtype=dtype, device=dev)
        bar = 1e-12 if dtype == torch.float64 else 5e-6
        # B4 alone: one phase of the P stream applied to the z frame, the
        # kernel against its plain version (one bmm per composite step)
        pl = wf_bt.plan(res, z)
        P, u0 = next(wf_bt.stream_phases(res, pl))
        zp0 = wf_bt.frame(z, pl)

        def apply_with(fn):
            def run():
                zp = zp0.clone()
                fn(P, zp, pl, u0)
                return zp
            return run

        got = apply_with(wf_bt.apply_phase)()
        torch.cuda.synchronize()
        ms = time_ms(apply_with(wf_bt.apply_phase), 5)
        plain_ms = time_ms(apply_with(wf_bt.apply_phase_plain), 5)
        ref = apply_with(wf_bt.apply_phase_plain)()
        zs = float(ref.abs().max())
        err = float((got - ref).abs().max())
        print(f"wf_bt {tag}: n={n} k={k} g={pl.g} m={pl.m}, phase 1 of "
              f"{pl.nph} ({P.shape[0]} of {pl.Tq2} composite steps), kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms, max |dz| {err:.3e} "
              f"(bar {bar:g} * {zs:.3g})")
        check(bool(torch.isfinite(got).all()) and err <= bar * zs,
              f"wf_bt {tag} kernel == plain")
        out["wf_bt"][tag] = {"ms": ms, "plain_ms": plain_ms,
                             "max_abs_err": err}
        del P, zp0
        # the whole chase back-transforms, P stream build included for B4
        whole = compare_bt("apply_chase_q_wavefront",
                           wf_bt.apply_chase_q_wavefront,
                           wf_bt.apply_chase_q_wavefront_plain, res, z, 3)
        out["wf_bt"][tag].update(with_stream_ms=whole["ms"],
                                 with_stream_plain_ms=whole["plain_ms"])
        # B5, and at each g it was chosen from; its library call is B4's
        # whole plain version on the same operands
        out["chase_bt"][tag] = dict(
            compare_chase_bt(res, z, "", 3, groups=(16, 32, 64)),
            library_ms=whole["plain_ms"])
        del res, band_m
        torch.cuda.empty_cache()
    return out


def add_launches(total: dict) -> None:
    for key, val in read_launches().items():
        total[key] = total.get(key, 0) + val


def phase_twostage_select(dev, tmp):
    """Phase 7: the two-stage selecting path at n = 16384, both dtypes;
    then its kernels against their plain versions at the path's shapes."""
    import torch

    from eigenkernel_tpu_torch.core.config import DEFAULT_BLOCK_SIZE
    from eigenkernel_tpu_torch.ops import band, sturm, tridiag_solve, wf_bt
    from eigenkernel_tpu_torch.ops.tridiag import INVIT_STEPS
    from eigenkernel_tpu_torch.solvers import twostage

    mat, path = write_elses(tmp, N_TWO, seed=3)
    ref = reference_eigvalsh(mat, dev)
    launches, checks = {}, {"chase": [], "wf_bt": [], "wf_bt_phases": [],
                            "sturm": [], "solve": [], "chase_bt": []}
    for dtype_name, bars in (("float64", (1e-12, 1e-10, 1e-10)),
                             ("float32", (1e-5, 1e-3, 1e-4))):
        work = os.path.join(tmp, f"two_{dtype_name}")
        os.makedirs(work)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with env(EK_SELECT_CORE="two_stage"), \
                capture(twostage, "apply_chase_q_wavefront") as calls, \
                capture(sturm, "sturm_bisect") as b1_calls, \
                capture(tridiag_solve, "tridiag_solve", 1) as b2_calls:
            out = run_cli(work, ["-s", "scalapack_select", "-n", str(K_TWO),
                                 "-c", str(K_TWO), "-t", f"1,{K_TWO}",
                                 "--dtype", dtype_name, path])
        solves = read_launches()["solve"]
        add_launches(launches)
        print(f"  peak device memory {dtype_name}: "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        check_run(work, out, ref, K_TWO, f"{dtype_name} two-stage", *bars)
        # B1 and B2 on the tridiagonal, targets, shifts and start block
        # the path gave them (the first of its inverse-iteration solves;
        # the peak above includes that recorded start block, n k words)
        check(len(b1_calls) == 1 and solves == INVIT_STEPS,
              f"the path called B1 once and B2 {INVIT_STEPS} times")
        b1_args = b1_calls.pop()
        checks["sturm"].append(compare_sturm(*b1_args, 2,
                                             "path operands")[1])
        if dtype_name == "float64":
            checks["sturm"][-1]["library_ms"] = eigvalsh_ms(*b1_args[:2])
        checks["solve"].append(compare_solve(*b2_calls.pop(), 3,
                                             "path operands"))
        # B4 on the chase result and eigenvectors the path gave it
        check(len(calls) == 1, "the path called B4 once")
        res, z = calls.pop()[:2]
        checks["wf_bt"].append(compare_bt(
            "apply_chase_q_wavefront (path operands)",
            wf_bt.apply_chase_q_wavefront,
            wf_bt.apply_chase_q_wavefront_plain, res, z))
        checks["wf_bt_phases"].append(
            compare_wf_bt_phases(res, z, " (path operands)"))
        # B5 on the same operands, beside B4's whole call
        b5 = compare_chase_bt(res, z, " (path operands)", 3)
        b4_ms = checks["wf_bt"][-1]["ms"]
        print(f"  n={N_TWO} k={K_TWO} {dtype_name}: B5 {b5['ms']:.3f} ms, "
              f"B4's whole call {b4_ms:.3f} ms")
        checks["chase_bt"].append(dict(b5, b4_whole_ms=b4_ms))
        del res, z
        if dtype_name == "float64":
            # B3 on the band of this matrix at the path's bandwidth
            a = torch.tensor(mat.to_dense(), device=dev)
            band_m = band.to_band(a, DEFAULT_BLOCK_SIZE).band
            del a
            chk = compare_chase(band_m, DEFAULT_BLOCK_SIZE, ref, "f64",
                                reps=1, recon=False)[1]
            checks["chase"].append(dict(chk, n=N_TWO, dtype="f64"))
            del band_m
        torch.cuda.empty_cache()
    print(f"launches on the two-stage selecting path: {launches}")
    check(launches["chase"] > 0 and launches["wf_bt"] > 0
          and launches["sturm"] > 0 and launches["solve"] > 0,
          "B1, B2, B3 and B4 launched on the two-stage selecting path")
    return launches, checks


def phase_eigensx(dev, tmp, n, seed, bt):
    """Phases 8 and 9: ``-s eigensx`` on the full spectrum, float64; then
    the path's back-transform kernel against its plain version on the
    operands the path gave it."""
    from eigenkernel_tpu_torch.ops import wf_bt
    from eigenkernel_tpu_torch.solvers import twostage

    mat, path = write_elses(tmp, n, seed=seed)
    ref = reference_eigvalsh(mat, dev)
    work = os.path.join(tmp, f"sx_{n}_{bt}")
    os.makedirs(work)
    if bt == "pallas":
        key, name = "chase_bt", "apply_chase_q_sweeps"
    else:
        key, name = "wf_bt", "apply_chase_q_wavefront"
    reset_launches()
    with env(EK_TRIDIAG="bisect", EK_BACKTRANSFORM=bt), \
            capture(twostage, name) as calls:
        out = run_cli(work, ["-s", "eigensx", "-c", "-1", "-t", f"1,{n}",
                             path])
    launches = read_launches()
    print(f"launches on eigensx n={n} EK_BACKTRANSFORM={bt}: {launches}")
    check(launches["chase"] > 0 and launches["sturm"] > 0
          and launches["solve"] > 0, "B1, B2 and B3 launched")
    check(launches[key] > 0, f"{key} launched")
    check_run(work, out, ref, n, f"float64 eigensx {bt}", 1e-12, 1e-10,
              1e-10)
    check(len(calls) == 1, f"the path called {name} once")
    res, z = calls.pop()[:2]
    if key == "chase_bt":
        # B5's library call: B4's whole plain version (P stream and one
        # torch.bmm a step), the same function
        lib_ms = time_ms(lambda: wf_bt.apply_chase_q_wavefront_plain(res, z),
                         1, batches=3)
        print(f"library: B4's whole plain version on these operands: "
              f"{lib_ms:.3f} ms")
        return launches, {key: [dict(compare_chase_bt(
            res, z, " (path operands)"), library_ms=lib_ms)]}
    return launches, {
        key: [compare_bt(f"{name} (path operands)",
                         wf_bt.apply_chase_q_wavefront,
                         wf_bt.apply_chase_q_wavefront_plain, res, z)],
        "wf_bt_phases": [compare_wf_bt_phases(res, z, " (path operands)")]}


def compare_deflate(levels, tag, step_ns):
    """D1 against its plain version, ``torch.equal`` on every record, on
    the operands each level of a path's divide and conquer gave it; each
    level timed with CUDA events (the call: where the kernel takes
    microseconds, the wrapper's host work bounds it) beside its bound (the
    chain of the level's most close steps in a merge, or its bytes) and
    the share of close steps.  Returns the sums over the levels (one
    tridiag_dc) and the levels; ``chain_ms`` is the one-step-at-a-time
    chain (K steps a level), the floor of the first design."""
    import torch

    from eigenkernel_tpu_torch.obs import flops
    from eigenkernel_tpu_torch.ops import dc

    rows, total = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                       "max_abs_err": 0.0, "chain_ms": 0.0}
    for args in levels:
        ds, us, alive, tol = args
        nb, K = ds.shape
        got = dc.deflate_scan(*args)
        torch.cuda.synchronize()
        ms = time_ms(lambda: dc.deflate_scan(*args), 3)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        plain = dc.deflate_scan_plain(*args)
        t1.record()
        torch.cuda.synchronize()
        plain_ms = t0.elapsed_time(t1)
        err = max(float((getattr(got, f).double()
                         - getattr(plain, f).double()).abs().max())
                  for f in dc.Deflation._fields)
        check(all(torch.equal(getattr(got, f), getattr(plain, f))
                  for f in dc.Deflation._fields),
              f"dc_deflate {tag} nb={nb} K={K} kernel == plain bit for bit")
        rot = int(got.rot_m.sum())
        close_max = int(got.rot_m.sum(dim=1).max())
        bound_ms, bound_by = flops.bound_deflate(nb, K, ds.dtype, step_ns,
                                                 close_max)
        print(f"dc_deflate {tag}: nb={nb} K={K}, {rot} close steps "
              f"({100 * rot / (nb * K):.2f} % of the steps; at most "
              f"{close_max} in a merge), deepest chain "
              f"{int(got.depths.max())}: kernel {ms:.4f} ms "
              f"({1e6 * ms / K:.1f} ns a step), plain {plain_ms:.1f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}), one-step-at-a-time "
              f"chain {1e-6 * K * step_ns:.4f} ms")
        rows.append({"nb": nb, "K": K, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "rotations": rot,
                     "close_share": rot / (nb * K), "close_max": close_max})
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("bound_ms", bound_ms),
                         ("chain_ms", 1e-6 * K * step_ns)):
            total[key] += val
        total["max_abs_err"] = max(total["max_abs_err"], err)
    total["bound_by"] = "operations" if all(
        r["bound_by"] == "operations" for r in rows) else "bytes"
    return dict(total, dtype=tag, levels=rows)


def profile_call(label, fn, *args, parts=None, warm=True):
    """One call of ``fn(*args)`` (after a warm-up call, with ``warm``)
    under torch.profiler: its wall time, the kernels it launched on the
    card, the device time of all of them and, for each entry of
    ``parts``, of those whose name holds that text (case ignored)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn(*args)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn(*args)
        torch.cuda.synchronize()
        wall = time.time() - t0
    kernels = [ev for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    launches = sum(1 for ev in prof.events()
                   if ev.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                  "cudaLaunchKernelExC"))
    busy_us = sum(ev.time_range.elapsed_us() for ev in kernels)
    out = {"wall_s": wall, "device_kernels": len(kernels),
           "launch_calls": launches, "device_busy_ms": busy_us / 1e3}
    for key, text in (parts or {}).items():
        out[key] = sum(ev.time_range.elapsed_us() for ev in kernels
                       if text in ev.name.lower()) / 1e3
    shares = ", ".join(f"{key} {out[key]:.3f} ms" for key in parts or {})
    print(f"profile of one {label}: {wall:.4f} s, {len(kernels)} kernels on "
          f"the card ({launches} launch calls), device busy "
          f"{busy_us / 1e3:.3f} ms; {shares}")
    return out


def profile_dc(d, e):
    """One ``tridiag_dc`` under torch.profiler: the kernels it launched on
    the card, D1's device time and the device time of all of them."""
    from eigenkernel_tpu_torch.ops import dc

    return profile_call(f"tridiag_dc n={d.shape[0]} {d.dtype}", dc.tridiag_dc,
                        d, e, parts={"d1_ms": "dc_deflate"})


def phase_dc(dev, tmp, chains):
    """Phase 10: the full spectrum through divide and conquer: -s
    scalapack (float64, float32), lapack and eigensx at n = 4096; then D1
    against its plain version on the scalapack runs' operands, the whole
    tridiag_dc against one eigh of T, and one profiled tridiag_dc a
    dtype."""
    import torch

    from eigenkernel_tpu_torch.ops import dc
    from eigenkernel_tpu_torch.tools import div_chain

    os.environ.pop("EK_TRIDIAG", None)
    mat, path = write_elses(tmp, N_DC, seed=7)
    ref = reference_eigvalsh(mat, dev)
    levels = dc._tree_shape(N_DC)[1]
    launches, scans, tri, out = {}, {}, {}, {"stages": {}, "peak_gib": {}}
    for dtype_name, bars in (("float64", (1e-12, 1e-10, 1e-10)),
                             ("float32", (1e-5, 1e-3, 1e-4))):
        work = os.path.join(tmp, f"dc_{dtype_name}")
        os.makedirs(work)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with capture(dc, "deflate_scan") as calls, \
                capture(dc, "tridiag_dc") as dc_calls:
            cli_out = run_cli(work, ["-s", "scalapack", "-c", "-1", "-t",
                                     f"1,{N_DC}", "--dtype", dtype_name,
                                     path])
        got = read_launches()
        add_launches(launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"  launches: {got}; peak device memory {peak:.2f} GiB")
        check(got["deflate"] == levels,
              f"{dtype_name} scalapack launched D1 once a level ({levels})")
        out["stages"][f"scalapack {dtype_name}"] = check_run(
            work, cli_out, ref, N_DC, f"{dtype_name} scalapack", *bars)
        out["peak_gib"][dtype_name] = peak
        scans[dtype_name] = calls
        tri[dtype_name] = dc_calls[0][:2]
    for solver, want in (("lapack", ()), ("eigensx", ("chase", "wf_bt",
                                                      "deflate"))):
        work = os.path.join(tmp, f"dc_{solver}")
        os.makedirs(work)
        reset_launches()
        cli_out = run_cli(work, ["-s", solver, "-c", "-1", "-t",
                                 f"1,{N_DC}", path])
        got = read_launches()
        print(f"  launches: {got}")
        check(all(got[k] > 0 for k in want),
              f"{solver} launched {', '.join(want) or 'no kernel'}")
        if solver == "eigensx":
            launches["deflate"] += got["deflate"]
        out["stages"][f"{solver} float64"] = check_run(
            work, cli_out, ref, N_DC, f"float64 {solver}", 1e-12, 1e-10,
            1e-10)
    # D1 on the path's operands, each level; its bound from this card's
    # measured step latency
    out["deflate"] = {}
    for dtype_name, tag in (("float64", "f64"), ("float32", "f32")):
        step = div_chain.step_ns(chains, "deflate", tag)
        out["deflate"][tag] = compare_deflate(scans[dtype_name], tag, step)
        out["deflate"][tag]["step_ns"] = step
    # the whole divide and conquer beside one eigh of the densified T (the
    # library call for the stage), and one profiled run
    for dtype_name, tag in (("float64", "f64"), ("float32", "f32")):
        d, e = tri[dtype_name]
        dc_ms = time_ms(lambda: dc.tridiag_dc(d, e), 1, batches=3)
        t = torch.diag(d) + torch.diag(e, 1) + torch.diag(e, -1)
        torch.linalg.eigh(t)
        eigh_ms = time_ms(lambda: torch.linalg.eigh(t), 1, batches=3)
        print(f"tridiag_dc {tag} n={N_DC}: {dc_ms:.3f} ms; "
              f"torch.linalg.eigh of T: {eigh_ms:.3f} ms")
        out["deflate"][tag].update(tridiag_dc_ms=dc_ms, eigh_ms=eigh_ms)
        del t
    out["profile"] = profile_dc(*tri["float64"])
    out["profile_f32"] = profile_dc(*tri["float32"])
    print(f"launches on the divide-and-conquer paths: {launches}")
    return launches, out


def overlap_like(mat, seed):
    """An SPD overlap matrix B with the sparsity of ``mat``: off-diagonal
    entries 0.2 e^(-|i-j|/16) N(0, 1), each diagonal entry 1 + the sum of
    its row's off-diagonal magnitudes (strictly diagonally dominant)."""
    import numpy as np

    from eigenkernel_tpu_torch.core.types import SparseMatrix

    rng = np.random.default_rng(seed)
    rows, cols = mat.rows, mat.cols
    off = rows != cols
    vals = np.where(off, 0.2 * np.exp(-np.abs(rows - cols) / 16.0)
                    * rng.standard_normal(rows.size), 0.0)
    rowsum = np.zeros(mat.size)
    np.add.at(rowsum, rows[off], np.abs(vals[off]))
    np.add.at(rowsum, cols[off], np.abs(vals[off]))
    vals[~off] = 1.0 + rowsum[rows[~off]]
    return SparseMatrix(mat.size, rows, cols, vals)


def phase_generalized(dev, tmp):
    """Phase 11: generalized problems at n = 4096 against a reference the
    smoke forms itself (its own float64 Cholesky of B on the card)."""
    import torch

    from eigenkernel_tpu_torch.io.matrix_market import write_matrix

    os.environ.pop("EK_TRIDIAG", None)
    mat, path_a = write_elses(tmp, N_GEN, seed=8)
    mat_b = overlap_like(mat, seed=9)
    path_b = os.path.join(tmp, f"B{N_GEN}_9.mtx")
    write_matrix(path_b, mat_b)
    a = torch.tensor(mat.to_dense(), device=dev)
    b = torch.tensor(mat_b.to_dense(), device=dev)
    l = torch.linalg.cholesky(b)
    c = torch.linalg.solve_triangular(l, a, upper=False)
    c = torch.linalg.solve_triangular(l, c.T, upper=False)
    ref = torch.linalg.eigvalsh((c + c.T) / 2).cpu().numpy()
    del a, b, l, c
    torch.cuda.empty_cache()
    out = {}
    runs = (("general_scalapacknew_eigens", "float64", None, ("deflate",)),
            ("general_scalapacknew_eigens", "float32", None, ("deflate",)),
            ("general_elpa2", "float64", None, ("chase", "wf_bt",
                                                 "deflate")),
            ("general_scalapack_select", "float64", K_GEN, ("sturm",
                                                             "solve")))
    launches = {}
    for solver, dtype_name, k, want in runs:
        f64 = dtype_name == "float64"
        kk = N_GEN if k is None else k
        work = os.path.join(tmp, f"gen_{solver}_{dtype_name}")
        os.makedirs(work)
        argv = ["-s", solver, "-c", str(kk), "-t", f"1,{kk}", "--dtype",
                dtype_name, path_a, path_b]
        if k is not None:
            argv = ["-n", str(k)] + argv
        reset_launches()
        cli_out = run_cli(work, argv)
        got = read_launches()
        add_launches(launches)
        print(f"  launches: {got}")
        check(all(got[key] > 0 for key in want),
              f"{solver} {dtype_name} launched {', '.join(want)}")
        out[f"{solver} {dtype_name}"] = check_run(
            work, cli_out, ref, kk, f"{dtype_name} {solver}",
            *((1e-12, 1e-10, 1e-10) if f64 else (1e-5, 1e-3, 1e-4)))
    print(f"launches on the generalized paths: {launches}")
    return launches, out, (path_a, path_b, ref)


def compare_pair_eigh(a, label, set_ns, probe):
    """D2 against its plain version on the batch ``a``, ``torch.equal`` on
    values, vectors, sweeps and rotations; timed with CUDA events beside
    its bound, one ``torch.linalg.eigh`` of the same batch (its library
    call, which the port does not make on this path) and the first
    design's recorded time on the same operands; then, through
    ``tools/pair_jacobi_profile.py`` (``probe``: its instrumented build of
    D2), the cycles a set of each phase, the instrumented build held bit
    for bit to the kernel."""
    import torch

    from eigenkernel_tpu_torch.obs import flops
    from eigenkernel_tpu_torch.ops import jacobi
    from eigenkernel_tpu_torch.tools import pair_jacobi_profile

    tag = "f64" if a.dtype == torch.float64 else "f32"
    m, w = a.shape[0], a.shape[1]
    got = jacobi.pair_eigh(a)
    torch.cuda.synchronize()
    ms = time_ms(lambda: jacobi.pair_eigh(a), 3)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    plain = jacobi.pair_eigh_plain(a)
    t1.record()
    torch.cuda.synchronize()
    plain_ms = t0.elapsed_time(t1)
    torch.linalg.eigh(a)
    torch.cuda.synchronize()
    lib_ms = time_ms(lambda: torch.linalg.eigh(a), 1, batches=3)
    err = max(float((getattr(got, f).double()
                     - getattr(plain, f).double()).abs().max())
              for f in jacobi.PairEigh._fields)
    sweeps, rot = int(got.sweeps.max()), int(got.rotations.sum())
    bound_ms, bound_by = flops.bound_pair_eigh(m, w, sweeps, rot, a.dtype,
                                               set_ns)
    sets = sweeps * (w - 1 + (w & 1))
    print(f"pair_jacobi {tag} {label}: m={m} w={w}, sweeps "
          f"{int(got.sweeps.min())}-{sweeps}, {rot} rotations: kernel "
          f"{ms:.3f} ms ({1e3 * ms / sets:.2f} us a set of the longest "
          f"block), plain {plain_ms:.1f} ms, torch.linalg.eigh {lib_ms:.3f} "
          f"ms, bound {bound_ms:.4f} ms ({bound_by}), max diff {err:.3e} "
          f"(bar: equal)")
    check(all(torch.equal(getattr(got, f), getattr(plain, f))
              for f in jacobi.PairEigh._fields),
          f"pair_jacobi {tag} {label} kernel == plain bit for bit")
    ref = torch.linalg.eigvalsh(a.double())
    ev_err = float((got.values.double().sort(dim=1).values - ref)
                   .abs().max() / ref.abs().max())
    bar = 1e-13 if tag == "f64" else 1e-4
    check(ev_err <= bar, f"pair_jacobi {tag} {label} values == eigvalsh "
                         f"({ev_err:.3e} <= {bar:g} of the largest)")
    first = FIRST_DESIGN_MS.get((tag, label))
    print(f"  the first design on the same operands (recorded): "
          f"{'none' if first is None else f'{first:.3f} ms'}")
    phases = pair_jacobi_profile.profile(probe, a)
    print("  cycles a set in block 0:\n"
          + pair_jacobi_profile.describe(phases))
    check(phases["cluster"]["equal"],
          f"pair_jacobi {tag} {label} instrumented build == the kernel bit "
          f"for bit")
    return {"m": m, "w": w, "dtype": tag, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err, "sweeps": sweeps,
            "rotations": rot, "us_per_set": 1e3 * ms / sets,
            "set_ns": set_ns, "cycles_a_set": phases["cluster"]["cycles"]}


def refine_by_steps(a64, v32, ref, steps=(4, 6, 8, 10, 12)):
    """The residual, orthogonality and eigenvalue error of the mixed
    refinement of ``v32`` against ``a64`` after each number of Newton
    steps (``EK_REFINE_STEPS``), and each one's time."""
    import torch

    from eigenkernel_tpu_torch.ops import refine

    n = a64.shape[0]
    anorm = float(a64.norm())
    rows = {}
    for k in steps:
        t0 = time.time()
        w, v = refine.refine_eigenpairs(a64, v32, steps=k)
        torch.cuda.synchronize()
        sec = time.time() - t0
        resid = float(((a64 @ v - v * w).norm(dim=0) / anorm).max())
        orth = float((v.T @ v - torch.eye(n, dtype=v.dtype,
                                          device=v.device)).abs().max())
        ev = float(abs(w.cpu().numpy() - ref[:n]).max())
        rows[k] = {"resid": resid, "orth": orth, "ev": ev, "s": sec}
        print(f"  refine {k:2d} steps: resid max {resid:.3e}, |V^T V - I| "
              f"{orth:.3e}, |eig - eigvalsh| {ev:.3e}, {sec:.3f} s")
    return rows


def phase_extra(dev, tmp, chains, gen_pair, dc_f64_s):
    """Phase 12: the jacobi and qdwh_dc cores and --dtype mixed at
    n = 4096; then D2 against its plain version on the path's pair
    blocks, a random batch and the dc leaves' batch."""
    import numpy as np
    import torch

    from eigenkernel_tpu_torch.ops import dc, jacobi
    from eigenkernel_tpu_torch.solvers import api
    from eigenkernel_tpu_torch.tools import div_chain, pair_jacobi_profile

    os.environ.pop("EK_TRIDIAG", None)
    mat, path = write_elses(tmp, N_X, seed=10)
    ref = reference_eigvalsh(mat, dev)
    path_a, path_b, ref_gen = gen_pair
    f64_bars, f32_bars = (1e-12, 1e-10, 1e-10), (1e-5, 1e-3, 1e-4)
    levels = dc._tree_shape(N_X)[1]
    rounds = N_X // 64 - 1
    runs = (
        # (label, argv, k, reference, bars, launches wanted)
        ("jacobi float64", ["-s", "jacobi"], N_X, ref, f64_bars,
         {"pair_eigh": rounds * 12}),
        ("jacobi float32", ["-s", "jacobi", "--dtype", "float32"], N_X, ref,
         f32_bars, {"pair_eigh": rounds * 8}),
        ("qdwh_dc float64", ["-s", "qdwh_dc"], N_X, ref, f64_bars, {}),
        ("scalapack mixed", ["-s", "scalapack", "--dtype", "mixed"], N_X,
         ref, f64_bars, {"deflate": levels}),
        ("scalapack float64 (same matrix)", ["-s", "scalapack"], N_X, ref,
         f64_bars, {"deflate": levels}),
        ("scalapack_select mixed", ["-s", "scalapack_select", "-n",
                                    str(K_X), "--dtype", "mixed"], K_X, ref,
         (1e-5, 1e-10, 1e-10), {"sturm": 1, "solve": 1}),
        ("general_elpa2 mixed", ["-s", "general_elpa2", "--dtype", "mixed"],
         N_GEN, ref_gen, f64_bars, {"chase": 1, "wf_bt": 1,
                                    "deflate": levels}),
        ("general_jacobi float64", ["-s", "general_jacobi"], N_GEN, ref_gen,
         f64_bars, {"pair_eigh": rounds * 12}),
        ("general_qdwh_dc float64", ["-s", "general_qdwh_dc"], N_GEN,
         ref_gen, f64_bars, {}),
    )
    launches, out = {}, {"stages": {}, "peak_gib": {}, "launches": {}}
    ends = refined = jac_args = None
    for label, argv, k, ref_k, bars, want in runs:
        work = os.path.join(tmp, "x_" + label.split(" (")[0]
                            .replace(" ", "_"))
        os.makedirs(work)
        files = [path_a, path_b] if label.startswith("general") else [path]
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with capture_ends(jacobi, "pair_eigh") as seen, \
                capture(api, "refine_eigenpairs", 1) as refines, \
                capture(jacobi, "block_jacobi_eigh", 1) as jac:
            cli_out = run_cli(work, argv + ["-c", str(k), "-t", f"1,{k}"]
                              + files)
        got = read_launches()
        if label != "scalapack float64 (same matrix)":
            add_launches(launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"  launches: {got}; peak device memory {peak:.2f} GiB")
        for key, n_want in want.items():
            exact = key == "pair_eigh" or key == "deflate"
            ok = got[key] == n_want if exact else got[key] >= n_want
            check(ok, f"{label} launched {key} {got[key]} times "
                      f"({'==' if exact else '>='} {n_want})")
        out["stages"][label] = check_run(work, cli_out, ref_k, k, label,
                                         *bars)
        out["peak_gib"][label] = peak
        out["launches"][label] = got
        if label == "jacobi float64":
            ends, jac_args = seen, jac[0]
        if label == "scalapack mixed":
            refined = refines[0][:2]
    mixed_s = out["stages"]["scalapack mixed"]["main:eigen_solver"]
    f64_s = out["stages"]["scalapack float64 (same matrix)"][
        "main:eigen_solver"]
    print(f"scalapack n={N_X}: --dtype mixed {mixed_s:.3f} s (refine "
          f"{out['stages']['scalapack mixed']['solve:refine']:.3f} s) "
          f"against float64 {f64_s:.3f} s on the same matrix (phase 10's "
          f"first float64 solve: {dc_f64_s:.3f} s)")
    out["mixed_vs_f64"] = {"mixed_s": mixed_s, "f64_s": f64_s,
                           "phase10_f64_s": dc_f64_s}
    # the refinement of that run's float32 vectors by step count (the
    # port's default is 8)
    out["refine_by_steps"] = refine_by_steps(*refined, ref)
    del refined
    # where the float64 jacobi core's time goes: D2, the products, the
    # gathers and scatters of the rounds (the CLI run warmed it up)
    out["profile_jacobi"] = profile_call(
        f"block_jacobi_eigh n={N_X} float64", jacobi.block_jacobi_eigh,
        *jac_args, parts={"d2_ms": "pair_jacobi", "gemm_ms": "gemm",
                          "index_ms": "index"}, warm=False)
    del jac_args
    # D2 on the float64 path's first and last round, a random batch and
    # the dc leaves' batch; its bound from this card's set latency; the
    # cycles a set by phase from an instrumented build beside it
    out["pair_eigh"] = {}
    with tempfile.TemporaryDirectory() as ptmp:
        probe = pair_jacobi_profile.build_designs(ptmp, ("cluster",))
    for tag, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        set_ns = div_chain.step_ns(chains, "pair_set", tag)
        rows = []
        if tag == "f64":
            check(ends["calls"] == rounds * 12,
                  f"recorded the {rounds * 12} pair eighs of the path")
            rows.append(dict(compare_pair_eigh(ends["first"][0],
                                               "path round 1", set_ns,
                                               probe),
                             label="path round 1"))
            rows.append(dict(compare_pair_eigh(
                ends["last"][0], f"path round {rounds * 12}", set_ns,
                probe), label=f"path round {rounds * 12}"))
        rng = np.random.default_rng(11)
        x = rng.standard_normal((32, 128, 128))
        x = torch.tensor(x + x.transpose(0, 2, 1), dtype=dtype, device=dev)
        rows.append(dict(compare_pair_eigh(x, "random", set_ns, probe),
                         label="random (32, 128, 128)"))
        base = dc._tree_shape(N_X)[0]
        nb = N_X // base
        d = rng.standard_normal((nb, base))
        e = rng.standard_normal((nb, base - 1))
        t = torch.tensor(np.stack([np.diag(d[i]) + np.diag(e[i], 1)
                                   + np.diag(e[i], -1) for i in range(nb)]),
                         dtype=dtype, device=dev)
        rows.append(dict(compare_pair_eigh(t, "dc leaves", set_ns,
                                           probe),
                         label=f"dc leaves ({nb}, {base}, {base})"))
        out["pair_eigh"][tag] = rows
    del ends
    torch.cuda.empty_cache()
    print(f"launches on the extra-core and mixed paths: {launches}")
    return launches, out


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
    from eigenkernel_tpu_torch.core.config import (
        DEFAULT_BLOCK_SIZE, set_matmul_precision_highest)
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
    # the latency of one step of each serial recurrence (D1's bound)
    from eigenkernel_tpu_torch.tools import div_chain

    chain_out = div_chain.run_chains()
    print(chain_out, end="")
    chains = div_chain.parse(chain_out)

    # phase 3: kernels against their plain versions
    kern = phase_kernels(dev)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        launches = phase_main(dev, tmp)
        print(f"main path: {time.time() - t0:.1f} s")
        t0 = time.time()
        phase_full(dev, tmp)
        print(f"full spectrum: {time.time() - t0:.1f} s")
        t0 = time.time()
        kern.update(phase_twostage_kernels(dev))
        print(f"two-stage kernels: {time.time() - t0:.1f} s")
        t0 = time.time()
        launches_two, path_checks = phase_twostage_select(dev, tmp)
        print(f"two-stage selecting path: {time.time() - t0:.1f} s")
        t0 = time.time()
        _, chk = phase_eigensx(dev, tmp, N_SX, seed=5, bt="auto")
        path_checks["wf_bt"] += chk["wf_bt"]
        path_checks["wf_bt_phases"] += chk["wf_bt_phases"]
        print(f"eigensx full spectrum: {time.time() - t0:.1f} s")
        t0 = time.time()
        launches_b5, chk = phase_eigensx(dev, tmp, N_B5, seed=6, bt="pallas")
        path_checks["chase_bt"] += chk["chase_bt"]
        print(f"eigensx under EK_BACKTRANSFORM=pallas: "
              f"{time.time() - t0:.1f} s")
        t0 = time.time()
        launches_dc, dc_out = phase_dc(dev, tmp, chains)
        print(f"full spectrum through divide and conquer: "
              f"{time.time() - t0:.1f} s")
        t0 = time.time()
        launches_gen, _, gen_pair = phase_generalized(dev, tmp)
        print(f"generalized problems: {time.time() - t0:.1f} s")
        t0 = time.time()
        launches_x, x_out = phase_extra(
            dev, tmp, chains, gen_pair,
            dc_out["stages"]["scalapack float64"]["main:eigen_solver"])
        print(f"extra cores and --dtype mixed: {time.time() - t0:.1f} s")
    launches.update(chase=launches_two["chase"], wf_bt=launches_two["wf_bt"],
                    chase_bt=launches_b5["chase_bt"],
                    deflate=launches_dc["deflate"])

    # each entry's numbers at one shape of its path: B1/B2 at phase 3's
    # n = 4096, k = 500 (and on the n = 16384 path's operands under
    # "path_checks"); B3 and B4 on the n = 16384 two-stage select path's
    # own band and operands; B5 at phase 6's n = 4096, k = 500 (and on the
    # n = 16384 and n = 2048 paths' operands under "path_checks"); float64
    from eigenkernel_tpu_torch.obs import flops

    f64 = torch.float64
    sel = {"chase": path_checks["chase"][0],
           "wf_bt": path_checks["wf_bt_phases"][0]}
    bounds = {
        "sturm": flops.bound_sturm(N_KERNEL, K_KERNEL, 62, f64),
        "solve": flops.bound_solve(N_KERNEL, K_KERNEL, f64),
        "chase": (sel["chase"]["bound_ms"], sel["chase"]["bound_by"]),
        "wf_bt": (sel["wf_bt"]["bound_ms"], sel["wf_bt"]["bound_by"]),
        "chase_bt": flops.bound_chase_bt(N_KERNEL, K_KERNEL,
                                         DEFAULT_BLOCK_SIZE, f64)}
    shapes = {"sturm": f"n={N_KERNEL} k={K_KERNEL} iters=62",
              "solve": f"n={N_KERNEL} k={K_KERNEL}",
              "chase": f"n={N_TWO} bw={DEFAULT_BLOCK_SIZE} (path band)",
              "wf_bt": f"n={N_TWO} k={K_TWO} (path operands)",
              "chase_bt": f"n={N_KERNEL} k={K_KERNEL}"}
    entries = []
    for key, name, src, replaces in (
            ("sturm", "sturm_bisect_kernel",
             "eigenkernel_tpu_torch/csrc/sturm_bisect.cu",
             "eigenkernel_tpu/ops/pallas_sturm.py:78"),
            ("solve", "tridiag_solve_kernel",
             "eigenkernel_tpu_torch/csrc/tridiag_solve.cu",
             "eigenkernel_tpu/ops/pallas_solve.py:114"),
            ("chase", "chase_kernel",
             "eigenkernel_tpu_torch/csrc/band_chase.cu",
             "eigenkernel_tpu/ops/pallas_chase.py:392"),
            ("wf_bt", "wf_bt_kernel",
             "eigenkernel_tpu_torch/csrc/wf_bt.cu",
             "eigenkernel_tpu/ops/pallas_wf_bt.py:242"),
            ("chase_bt", "chase_bt_kernel",
             "eigenkernel_tpu_torch/csrc/chase_bt.cu",
             "eigenkernel_tpu/ops/pallas_backtransform.py:108")):
        at = sel.get(key, kern[key]["f64"])
        # float32 at the same shape where the path gave one (B4), else at
        # the kernel comparison's n = 4096
        f32 = (path_checks["wf_bt_phases"][1] if key == "wf_bt" else
               dict(kern[key]["f32"], shape=f"n={N_KERNEL} k={K_KERNEL}"))
        entries.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[key],
                        "max_abs_err": at["max_abs_err"], "ms": at["ms"],
                        "plain_ms": at["plain_ms"],
                        "bound_ms": bounds[key][0],
                        "bound_by": bounds[key][1],
                        "library_ms": at.get("library_ms"),
                        "shape": shapes[key], "dtype": "float64",
                        "float32": f32,
                        "phase_kernels": kern[key]["f64"],
                        "path_checks": path_checks.get(key, [])
                        + (path_checks["wf_bt_phases"] if key == "wf_bt"
                           else [])})
    # D1: the six levels of one float64 tridiag_dc at n = 4096 on the
    # scalapack path's operands; not a TPU kernel (it replaces the
    # deflation lax.scans of the JAX function)
    d1 = dc_out["deflate"]["f64"]
    entries.append({"name": "dc_deflate_kernel", "route": "cuda",
                    "source": "eigenkernel_tpu_torch/csrc/dc_deflate.cu",
                    "replaces": "eigenkernel_tpu/ops/dc.py:222",
                    "launches": launches["deflate"],
                    "max_abs_err": d1["max_abs_err"], "ms": d1["ms"],
                    "plain_ms": d1["plain_ms"], "bound_ms": d1["bound_ms"],
                    "bound_by": d1["bound_by"], "library_ms": None,
                    "shape": f"n={N_DC}, the {len(d1['levels'])} levels of "
                             f"one tridiag_dc (path operands)",
                    "dtype": "float64", "float32": dc_out["deflate"]["f32"],
                    "path_checks": [dc_out["profile"],
                                    dc_out["profile_f32"],
                                    {"launches_generalized":
                                     launches_gen["deflate"]}]})
    # D2: the float64 jacobi path's first-round pair blocks (dense, the
    # most sweeps); not a TPU kernel (it replaces the library eigh of the
    # pair blocks in the JAX function)
    d2 = x_out["pair_eigh"]["f64"][0]
    entries.append({"name": "pair_jacobi_kernel", "route": "cuda",
                    "source": "eigenkernel_tpu_torch/csrc/pair_jacobi.cu",
                    "replaces": "eigenkernel_tpu/ops/jacobi.py:94",
                    "launches": launches_x["pair_eigh"],
                    "max_abs_err": d2["max_abs_err"], "ms": d2["ms"],
                    "plain_ms": d2["plain_ms"], "bound_ms": d2["bound_ms"],
                    "bound_by": d2["bound_by"],
                    "library_ms": d2["library_ms"],
                    "shape": f"m={d2['m']} w={d2['w']}, the n={N_X} "
                             f"jacobi path's round 1 (path operands)",
                    "dtype": "float64",
                    "float32": x_out["pair_eigh"]["f32"][0],
                    "path_checks": x_out["pair_eigh"]["f64"][1:]
                    + [{"launches_by_run": x_out["launches"],
                        "mixed_vs_f64": x_out["mixed_vs_f64"],
                        "refine_by_steps": x_out["refine_by_steps"],
                        "profile_jacobi": x_out["profile_jacobi"]}]})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
