"""Seconds of the CLI's ``main:read_matrix_files`` with each MatrixMarket
reader: the NumPy parser (``matrix_market._read_numpy``) and the native
one (``io/native_mm.py``, ``csrc/mmio.cpp``).

    python -m eigenkernel_tpu_torch.tools.read_time [n] [--platform cpu]

Writes an ELSES-style coordinate file (n = 16384 by default, seed 0: a
band of half-width 64 with hoppings decaying as e^(-offset/16), 1 % of
the other lower-triangle pairs as weak long-range couplings) into a
temporary directory, then runs the CLI with ``--dry-run`` (read,
densify, copy to the device, exit) three times with each reader in
turns (numpy, native, native, numpy, ...), and prints the host's CPU,
the card (``nvidia-smi``), the file's size and each run's
``main:read_matrix_files`` and ``main:bcast_sparse_matrices`` from
``log.json``, and the medians as one JSON line.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import platform
import statistics
import subprocess
import sys
import tempfile

import numpy as np


def elses_file(path: str, n: int, seed: int = 0) -> int:
    """Write the matrix; returns its entries."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for off in range(65):
        i = np.arange(off, n)
        rows.append(i)
        cols.append(i - off)
        vals.append(rng.standard_normal(i.size)
                    * (1.0 if off == 0 else np.exp(-off / 16.0)))
    m = int(0.01 * (n - 65) * (n - 64) // 2)
    i = rng.integers(65, n, size=m)
    key = np.unique(i * n + (rng.random(m) * (i - 64)).astype(np.int64))
    rows.append(key // n)
    cols.append(key % n)
    vals.append(rng.standard_normal(key.size) * 0.05)
    r, c, v = (np.concatenate(x) for x in (rows, cols, vals))
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real symmetric\n")
        f.write(f"{n} {n} {r.size}\n")
        np.savetxt(f, np.column_stack([r + 1, c + 1, v]),
                   fmt=["%d", "%d", "%.16e"])
    return int(r.size)


@contextlib.contextmanager
def reader(kind: str):
    """Coordinate files through the NumPy parser inside the block for
    ``kind`` = "numpy"; the native parser (the default) otherwise."""
    from eigenkernel_tpu_torch.io import matrix_market as mm
    from eigenkernel_tpu_torch.io import native_mm

    native = native_mm.read_coordinate
    if kind == "numpy":
        native_mm.read_coordinate = mm._read_numpy
    try:
        yield
    finally:
        native_mm.read_coordinate = native


def main(argv) -> int:
    from eigenkernel_tpu_torch import cli

    platform_arg = "cpu" if argv[-2:] == ["--platform", "cpu"] else "cuda"
    args = argv[:-2] if platform_arg == "cpu" else argv
    n = int(args[0]) if args else 16384
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip() if platform_arg == "cuda" \
        else "no card"
    print(f"{smi}; host {platform.processor() or platform.machine()}, "
          f"{os.cpu_count()} CPUs")
    times = {"numpy": [], "native": []}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "A.mtx")
        entries = elses_file(path, n)
        print(f"n={n}: {entries} entries, "
              f"{os.path.getsize(path) / 2**20:.1f} MiB")
        for kind in ("numpy", "native", "native", "numpy", "numpy",
                     "native"):
            log = os.path.join(tmp, "log.json")
            with reader(kind), contextlib.redirect_stdout(io.StringIO()), \
                    contextlib.redirect_stderr(io.StringIO()):
                rc = cli.main(["--platform", platform_arg, "--dry-run",
                               "-s", "scalapack", "-l", log, path])
            if rc != 0:
                raise RuntimeError(f"the CLI exited {rc}")
            with open(log) as f:
                ev = {e["name"]: e["val"] for e in json.load(f)["events"]}
            times[kind].append(ev["main:read_matrix_files"])
            print(f"  {kind}: main:read_matrix_files "
                  f"{ev['main:read_matrix_files']:.6f} s, "
                  f"main:bcast_sparse_matrices "
                  f"{ev['main:bcast_sparse_matrices']:.6f} s")
    print(json.dumps({"n": n, "entries": entries, "device": smi,
                      **{f"{k}_s": statistics.median(v)
                         for k, v in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
