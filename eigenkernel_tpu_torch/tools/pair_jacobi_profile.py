"""Where a set of rotations of the pair-eigh kernel (D2) spends its time.

    python -m eigenkernel_tpu_torch.tools.pair_jacobi_profile [designs] [n]

(from the repository's root: the matrix is ``chip_smoke.py``'s).

Builds instrumented copies of the kernel's designs, in which each warp's
lane 0 posts the SM clock at which the warp reached a barrier (a shared
atomic max) and thread 0 of the CTA reads the clock after it; the cycles
up to the last warp's arrival count as the phase's work, the rest as the
barrier.  Thread 0's bookkeeping (a few shared-memory accesses a barrier)
is the only code added: the instrumented kernels give the same bits.
The designs (a comma-separated list, both by default):

* ``rowcol``: the first design (``tools/pair_jacobi_rowcol.cu``, kept as
  the yardstick for the port's kernel; only this tool runs it), one CTA a
  block; segments: the rotation parameters, the
  rows of A, the columns of A with the rows of V^T, and the sweep-end
  count;
* ``cluster``: the port's kernel (``csrc/pair_jacobi.cu``), a cluster of
  two CTAs a block; CTA 0's segments: the rotation parameters (with
  sending them to CTA 1) and the 2 x 2 tiles of A; CTA 1's: the wait for
  a set's rotations and their application to V^T.

The batch is round 1 of the float64 ``jacobi`` path at n (4096 by
default): the (n / 128, 128, 128) pair blocks of the tournament's first
round of the ELSES-style matrix ``chip_smoke.py`` makes (its
``elses_like``, seed 10).  Prints the card, each design's uninstrumented time
(CUDA events), the sets block 0 ran, and the cycles a set of each
segment in block 0 (CTA 0, and CTA 1 for the cluster design).  Float64
and float32.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

from eigenkernel_tpu_torch.ops import build, jacobi

ROWCOL_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "pair_jacobi_rowcol.cu")
DESIGNS = {
    "rowcol": (ROWCOL_SOURCE,
               {0: ("parameters", "rows", "columns + V^T", "sweep end")}),
    "cluster": (os.path.join(build.CSRC, "pair_jacobi.cu"),
                {0: ("parameters", "tiles"), 1: ("wait", "V^T")}),
}

_PROBE = r"""
#define EK_PROBE 1
__device__ unsigned long long ek_prof[2][16];
__device__ unsigned long long ek_sets[2];
#define EK_PROBE_BEGIN()                                               \
  __shared__ unsigned long long ek_arr_[2];                            \
  if (threadIdx.x == 0) ek_arr_[0] = ek_arr_[1] = 0;                   \
  __syncthreads();                                                     \
  unsigned long long ek_acc_[16] = {};                                 \
  long long ek_t0_ = clock64();                                        \
  int ek_seq_ = 0
#define EK_PROBE_ARRIVE()                                              \
  do {                                                                 \
    if ((threadIdx.x & 31) == 0)                                       \
      atomicMax(&ek_arr_[ek_seq_ & 1],                                 \
                static_cast<unsigned long long>(clock64()));           \
  } while (0)
#define EK_PROBE(k)                                                    \
  do {                                                                 \
    if (threadIdx.x == 0) {                                            \
      const long long now_ = clock64();                                \
      const long long mx_ = max(                                       \
          static_cast<long long>(ek_arr_[ek_seq_ & 1]), ek_t0_);       \
      ek_arr_[ek_seq_ & 1] = 0;                                        \
      ek_acc_[2 * (k)] += mx_ - ek_t0_;                                \
      ek_acc_[2 * (k) + 1] += now_ - mx_;                              \
      ek_t0_ = now_;                                                   \
    }                                                                  \
    ++ek_seq_;                                                         \
  } while (0)
#define EK_PROBE_MARK(k)                                               \
  do {                                                                 \
    if (threadIdx.x == 0) {                                            \
      const long long now_ = clock64();                                \
      ek_acc_[2 * (k)] += now_ - ek_t0_;                               \
      ek_t0_ = now_;                                                   \
    }                                                                  \
  } while (0)
#define EK_PROBE_END(sets)                                             \
  do {                                                                 \
    if (threadIdx.x == 0 && blockIdx.x < 2) {                          \
      for (int i_ = 0; i_ < 16; ++i_)                                  \
        ek_prof[blockIdx.x][i_] = ek_acc_[i_];                         \
      ek_sets[blockIdx.x] = (sets);                                    \
    }                                                                  \
  } while (0)
"""

_READ = r"""
extern "C" int ek_prof_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, ek_prof, sizeof(ek_prof));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaMemcpyFromSymbol(out + 32, ek_sets,
                                               sizeof(ek_sets)));
}
"""

_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int] + [
    ctypes.c_void_p] * 5


def build_designs(tmp: str, designs=tuple(DESIGNS)) -> dict:
    """{design: {"probe": instrumented library, "plain": library}}: every
    library built by its own nvcc, all at once (the port's own kernel is
    the plain library of the cluster design)."""
    jobs = {}
    for name in designs:
        path = DESIGNS[name][0]
        with open(path) as f:
            src = f.read()
        variants = [("probe", _PROBE + src + _READ)]
        if name != "cluster":
            variants.append(("plain", src))
        for kind, text in variants:
            cu = os.path.join(tmp, f"{name}_{kind}.cu")
            so = os.path.join(tmp, f"lib{name}_{kind}.so")
            with open(cu, "w") as f:
                f.write(text)
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu]
            jobs[name, kind] = (so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for (name, kind), (so, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise build.KernelCompileError(f"{name} {kind}:\n{out}")
        lib = ctypes.CDLL(so)
        for tag in ("f64", "f32"):
            fn = getattr(lib, f"ek_pair_jacobi_{tag}")
            fn.argtypes = _ARGS
            fn.restype = ctypes.c_int
        lib.ek_pair_jacobi_resident.argtypes = [ctypes.c_int, ctypes.c_int]
        libs.setdefault(name, {})[kind] = lib
    return libs


def launch(lib, a: torch.Tensor) -> jacobi.PairEigh:
    """One launch of a design's library on the batch ``a`` (m, w, w), with
    the port's operands and outputs (``ops/jacobi.py::_launch``)."""
    m, w = a.shape[0], a.shape[1]
    tag = "f64" if a.dtype == torch.float64 else "f32"
    values = torch.empty((m, w), dtype=a.dtype, device=a.device)
    vt = torch.empty((m, w, w), dtype=a.dtype, device=a.device)
    counts = torch.empty((2, m), dtype=torch.int32, device=a.device)
    work = None
    if not lib.ek_pair_jacobi_resident(w, a.element_size()) & 1:
        work = torch.empty((m, w, w + 1), dtype=a.dtype, device=a.device)
    status = getattr(lib, f"ek_pair_jacobi_{tag}")(
        a.data_ptr(), m, w, jacobi.MAX_SWEEPS, values.data_ptr(),
        vt.data_ptr(), counts.data_ptr(),
        0 if work is None else work.data_ptr(),
        torch.cuda.current_stream(a.device).cuda_stream)
    build.check(status, f"ek_pair_jacobi_{tag}")
    return jacobi.PairEigh(values=values, vectors=vt.transpose(1, 2),
                           sweeps=counts[0], rotations=counts[1])


def _time_ms(fn, reps: int = 3, batches: int = 5) -> float:
    times = []
    for _ in range(batches):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / reps)
    return statistics.median(times)


def profile(libs: dict, a: torch.Tensor) -> dict:
    """Each built design on the batch ``a``: its time (ms, CUDA events:
    the port's ``pair_eigh`` for the cluster design), whether its plain
    and instrumented outputs equal the port's kernel's bit for bit, the
    sets block 0 ran, and per CTA the cycles a set of each segment's work
    and barrier."""
    ref = jacobi.pair_eigh(a)
    torch.cuda.synchronize()
    out = {}
    for name, kinds in libs.items():
        segments = DESIGNS[name][1]
        if name == "cluster":
            ms = _time_ms(lambda: jacobi.pair_eigh(a))
            same = True
        else:
            got = launch(kinds["plain"], a)
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(got, ref))
            ms = _time_ms(lambda: launch(kinds["plain"], a))
        got = launch(kinds["probe"], a)
        torch.cuda.synchronize()
        same = same and all(torch.equal(x, y) for x, y in zip(got, ref))
        raw = (ctypes.c_ulonglong * 34)()
        build.check(kinds["probe"].ek_prof_read(raw), "ek_prof_read")
        sets = raw[32]
        ctas = {}
        for cta, names in segments.items():
            ctas[cta] = {seg: (raw[16 * cta + 2 * k] / sets,
                               raw[16 * cta + 2 * k + 1] / sets)
                         for k, seg in enumerate(names)}
        out[name] = {"ms": ms, "equal": same, "sets": sets, "cycles": ctas}
    return out


def describe(result: dict) -> str:
    """One line a design: time, sets, cycles a set by segment."""
    lines = []
    for name, r in result.items():
        parts = []
        for cta, segs in r["cycles"].items():
            total = sum(w + b for w, b in segs.values())
            parts.append(f"CTA {cta}: " + ", ".join(
                f"{seg} {w:.0f} + barrier {b:.0f}"
                for seg, (w, b) in segs.items()) + f" (total {total:.0f})")
        lines.append(f"  {name}: {r['ms']:.3f} ms, block 0 ran {r['sets']} "
                     f"sets ({1e3 * r['ms'] / r['sets']:.2f} us a set); "
                     f"equal to the port's kernel: {r['equal']}; cycles a "
                     f"set: " + "; ".join(parts))
    return "\n".join(lines)


def round_one_batch(a: torch.Tensor, b: int = 64) -> torch.Tensor:
    """The pair blocks ``block_jacobi_eigh`` hands the pair eigh in its
    first round (n a multiple of 2 b)."""
    nb = a.shape[0] // b
    rows = torch.as_tensor(jacobi._pair_rows(jacobi._tournament(nb), b)[0],
                           dtype=torch.int64, device=a.device)
    sub = a[rows[:, :, None], rows[:, None, :]]
    return (sub + sub.transpose(1, 2)) * 0.5


def main(argv) -> int:
    designs = tuple(argv[0].split(",")) if argv else tuple(DESIGNS)
    n = int(argv[1]) if len(argv) > 1 else 4096
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi)
    from chip_smoke import elses_like

    rows, cols, vals = elses_like(n, seed=10)
    dense = np.zeros((n, n))
    dense[rows, cols] = vals
    dense = np.tril(dense) + np.tril(dense, -1).T
    a = torch.tensor(dense, device=torch.device("cuda"))
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_designs(tmp, designs)
        for dtype in (torch.float64, torch.float32):
            batch = round_one_batch(a.to(dtype))
            print(f"{dtype}: round 1 of n={n}, m={batch.shape[0]} "
                  f"w={batch.shape[1]}")
            print(describe(profile(libs, batch)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
