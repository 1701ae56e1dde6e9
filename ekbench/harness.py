"""One run of one cell: set-up, the timed window, the traced solve, the
check, and the result line.

Set-up (``setup_s``, from the process's start): import PyTorch and the
port, load the hand kernels from their build cache (``ops/build.py``; the
first run in a checkout compiles them), make the configuration's
matrices from the seed and densify them on the card, and run one warm
solve at the cell's own shape.

The window drives ``eigenkernel_tpu_torch.solve`` on those device-resident
matrices with the cell's solver, ``n_vec`` and ``dtype``, each solve ending
in ``torch.cuda.synchronize()``, back to back; a new solve starts only
while less than ``--seconds`` has passed.  ``solve_s`` is the window's
wall time over its solves, ``peak_mem_gib`` the allocator's peak over it
(reset at its start).  Each solve's values are kept, and a sample of its
columns drawn from the seed; the last solve is kept whole.

With ``--trace 1`` every solve of the window carries an
``EventLog(stream=False)`` (the stage seconds), and one more solve runs
under ``torch.profiler`` after it (``devtrace.py``); the per-layer
metrics (``metrics/<name>.py``) read both.

The check then makes the matrices again from the seed and judges every
kept output against the plain reference (``reference.py``) with the
cell's ``limits``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
import traceback
from dataclasses import dataclass, field

import numpy as np

from ekbench import data, devtrace, reference

FORBIDDEN = ("jax", "jaxlib", "flax", "eigenkernel_tpu", "bench", "chip_smoke")
SAMPLE_COLUMNS = 64
GIB = 2 ** 30


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def sample_columns(k: int, seed: int) -> np.ndarray:
    """The columns kept of every solve but the last: the first and the
    last, and ``SAMPLE_COLUMNS - 2`` more drawn from the seed."""
    pick = data.rng(seed, 99).choice(k, size=min(k, SAMPLE_COLUMNS),
                                     replace=False)
    return np.unique(np.concatenate([[0, k - 1], pick]))


@dataclass
class LayerRun:
    """What a per-layer metric reads: the cell, the traced window's stage
    events ({name: total seconds}) over its ``solves``, the profiled
    solve's :class:`~ekbench.devtrace.Trace`, and the problem's sizes."""
    cell: dict
    n: int
    n_vec: int
    bw: int
    itemsize: int
    solves: int = 0
    events: dict = field(default_factory=dict)
    trace: object = None

    def stage_s(self, *names: str):
        """Seconds a solve of the named stages together; None if the
        solves ran none of them."""
        hit = [self.events[n] for n in names if n in self.events]
        if not hit or self.solves == 0:
            return None
        return sum(hit) / self.solves


def read_metric(name: str, run: LayerRun):
    path = os.path.join(data.HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"ekbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: dict, cfg: dict, seed: int, seconds: float, trace: bool,
             device, e2e: dict, layers: dict, t_start: float,
             warm: bool = True) -> dict:
    """One run; returns the result line's object.  ``e2e`` and ``layers``
    map the metric names to report to their units."""
    import torch

    import eigenkernel_tpu_torch
    from eigenkernel_tpu_torch.obs.events import EventLog

    device = torch.device(device)
    split = {"import": time.perf_counter() - t_start}
    t = time.perf_counter()
    if device.type == "cuda":
        from eigenkernel_tpu_torch.ops import build

        build.library()
    split["build"] = time.perf_counter() - t
    t = time.perf_counter()
    mats = data.make(cfg, seed, device)
    a, b = mats["a"], mats.get("b")
    del mats
    _sync(torch, device)
    split["data"] = time.perf_counter() - t
    n = int(cfg["n"])
    k = n if cell.get("n_vec") is None else int(cell["n_vec"])
    dtype = cell.get("dtype", "float64")

    def solve(log=None):
        return eigenkernel_tpu_torch.solve(a, b, solver=cell["solver"],
                                           n_vec=cell.get("n_vec"),
                                           dtype=dtype, log=log)

    t = time.perf_counter()
    if warm:
        out = solve()
        _sync(torch, device)
        del out
    split["warm"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    say("setup_split_s " + json.dumps(split))

    # the window
    idx_np = sample_columns(k, seed)
    idx = torch.as_tensor(idx_np, device=device)
    log = EventLog(stream=False) if trace else None
    values, samples, times = [], [], []
    gc.collect()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        out = solve(log)
        _sync(torch, device)
        te = time.perf_counter()
        times.append(te - ts)
        values.append(out.values.clone())
        if te - t0 >= seconds:
            break
        samples.append(out.vectors[:, idx].clone())
        del out
    window_s = te - t0
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    last_values, last_vectors = values[-1], out.vectors
    del out
    say("solve_times_s " + json.dumps(times))

    result = {"metrics": {}}
    metrics = {"setup_s": setup_s, "solve_s": window_s / len(times),
               "peak_mem_gib": peak / GIB}
    attempted = len(times)
    if trace:
        # the window's last solve is sampled too, and the profiled solve
        # is kept whole in its place
        samples.append(last_vectors[:, idx].clone())
        del last_vectors
        out, tr = devtrace.profile(solve, device, devtrace.StampedLog())
        values.append(out.values.clone())
        last_values, last_vectors = values[-1], out.vectors
        del out
        attempted += 1
        bw = int(cell.get("env", {}).get("EK_TWOSTAGE_BW", 0)) or 64
        itemsize = 4 if dtype in ("float32", "mixed") else 8
        run = LayerRun(cell, n, k, bw, itemsize, len(times),
                       {e["name"]: e["val"] for e in log.events()}, tr)
        for name, unit in layers.items():
            v = read_metric(name, run)
            if v is not None:
                result["metrics"][name] = {"value": v, "unit": unit}
        if tr.busy_s > 0:
            result["breakdown"] = tr.breakdown()
        say("trace " + json.dumps({"window_s": tr.window_s,
                                   "busy_s": tr.busy_s,
                                   "kernels": tr.kernels,
                                   "seconds": tr.seconds}))
    else:
        for name, unit in e2e.items():
            result["metrics"][name] = {"value": metrics[name], "unit": unit}

    # the check, from matrices made again from the seed
    del a, b
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    limits = cell["limits"]
    try:
        mats = data.make(cfg, seed, device)
        ref = reference.eigenvalues(mats["a"], mats.get("b"))
        nums = reference.judge(mats["a"], mats.get("b"), ref, k, values,
                               samples, idx, last_values, last_vectors)
    except Exception:     # a crash or a wrong shape fails the check
        say("check raised:\n" + traceback.format_exc())
        nums = {key: reference.WRONG for key in limits}
        nums["per_solve"] = [(reference.WRONG,) * 3] * attempted
    say(f"check_s {time.perf_counter() - t}")
    failed = sum(1 for p in nums["per_solve"]
                 if any(x > limits[key] for x, key in
                        zip(p, ("eig_err", "residual", "orth"))))
    result["correct"] = failed == 0
    result["attempted"] = attempted
    result["failed"] = failed
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
    result["device"] = dev
    result["checks"] = {key: {"value": nums[key], "limit": limits[key]}
                        for key in ("eig_err", "residual", "orth")}
    return result


def line(result: dict) -> str:
    """The result line, its keys in the contract's order, ``checks``
    last."""
    order = ("correct", "attempted", "failed", "metrics", "device",
             "breakdown", "checks")
    return json.dumps({key: result[key] for key in order if key in result})


def power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"
