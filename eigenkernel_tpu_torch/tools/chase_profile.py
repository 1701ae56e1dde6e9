"""Where a step of the bulge-chase kernel (B3) spends its time.

    python -m eigenkernel_tpu_torch.tools.chase_profile [n] [b] [source.cu]

Builds an instrumented copy of ``csrc/band_chase.cu`` (CTA 0 reads the SM
clock at each phase boundary and sums the cycles per segment; the kernel
is otherwise the one the port runs) and runs it on the band of a random
symmetric matrix (n = 16384, b = 64 by default, float64 and float32, seed
0).  Prints the card, the uninstrumented kernel's time per chase (CUDA
events), and per step the cycles of CTA 0 in each segment: staging the
window (a carried window: the rows the lane's previous step left), phase
1 (the Householder), phase 2 (the dot products), phase 3 (the update),
the write-back, and the grid barrier (the wait for the slowest CTA
included); a lane whose reflector is the identity skips phases 2 and 3,
and their cycles fall to the write-back.  The window branch only.  A third argument
profiles another version of the source instead (same entry points).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from eigenkernel_tpu_torch.ops import band, build, chase

SEGMENTS = ("stage", "phase 1", "phase 2", "phase 3", "write-back",
            "barrier")

_PROBE = r"""
__device__ unsigned long long ek_prof[8];
__device__ long long ek_t0;
#define EK_PROBE(k)                                       \
  do {                                                    \
    if (blockIdx.x == 0) {                                \
      __syncthreads();                                    \
      if (threadIdx.x == 0) {                             \
        const long long t_ = clock64();                   \
        ek_prof[k] += t_ - ek_t0;                         \
        ek_t0 = t_;                                       \
      }                                                   \
    }                                                     \
  } while (0)
"""

# (anchor, text inserted after it) in csrc/band_chase.cu
_EDITS = (
    ("namespace {\n", _PROBE),
    ("    if (carry) prefetch_rows(grow + 2 * b * W, pref, b * W);\n  }\n",
     "  EK_PROBE(0);\n"),
    ("  if (tid == 0) ht[at] = th;\n"
     "  __syncthreads();\n", "  EK_PROBE(1);\n"),
    ("  const T tt_vdv = th * th * vdv;\n", "  EK_PROBE(2);\n"),
    ("          A.st(r, b - 1 + s - r, l[k] - th * (vr * cl[s]));\n      }\n"
     "    }\n  }\n", "  EK_PROBE(3);\n"),
    ("    store_faces(grow, win, b, carry ? b : 2 * b);\n  }\n",
     "  EK_PROBE(4);\n"),
    ("    grid_sync(bar, target);\n", "    EK_PROBE(5);\n"),
    ("  unsigned target = 0;\n",
     "  if (blockIdx.x == 0 && threadIdx.x == 0) ek_t0 = clock64();\n"),
)

_READ = r"""
extern "C" int ek_prof_read(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, ek_prof,
                                               sizeof(ek_prof)));
}
extern "C" int ek_prof_reset() {
  unsigned long long z[8] = {};
  return static_cast<int>(cudaMemcpyToSymbol(ek_prof, z, sizeof(z)));
}
"""


def instrumented_source(path: str = "") -> str:
    with open(path or os.path.join(build.CSRC, "band_chase.cu")) as f:
        src = f.read()
    for anchor, text in _EDITS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in band_chase.cu: "
                               f"{anchor!r}")
        src = src.replace(anchor, anchor + text)
    return src + _READ


def _build(tmp: str, path: str = "") -> ctypes.CDLL:
    src, lib = os.path.join(tmp, "chase_prof.cu"), os.path.join(
        tmp, "libchase_prof.so")
    with open(src, "w") as f:
        f.write(instrumented_source(path))
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib, src],
                   check=True, capture_output=True)
    return ctypes.CDLL(lib)


def profile(lib, band_m: torch.Tensor, b: int):
    """(cycles per step of each segment, of probes 6 and 7 where a source
    has them, steps, d) of one instrumented chase."""
    n = band_m.shape[0]
    tag = "f64" if band_m.dtype == torch.float64 else "f32"
    fn, res_fn = getattr(lib, f"ek_band_chase_{tag}"), getattr(
        lib, f"ek_band_chase_resident_{tag}")
    res_fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    window = int(chase.branch(b, band_m.dtype) == "window")
    if not window:
        raise ValueError(f"b = {b}: the window branch only")
    blocks = ctypes.c_int(0)
    build.check(res_fn(b, window, ctypes.byref(blocks)), "resident")
    grid = chase.grid_size(n, b, blocks.value)
    lb = chase.lower_storage(band_m, b)
    T = chase.n_positions(n, b)
    hv, ht = lb.new_zeros((n, T, b)), lb.new_zeros((n, T))
    bar = torch.zeros(1, dtype=torch.int32, device=band_m.device)
    build.check(lib.ek_prof_reset(), "reset")
    stream = torch.cuda.current_stream().cuda_stream
    build.check(fn(lb.data_ptr(), hv.data_ptr(), ht.data_ptr(),
                   bar.data_ptr(), n, b, hv.shape[1], 0, n - 3, window, grid,
                   stream),
                "chase")
    torch.cuda.synchronize()
    out = (ctypes.c_ulonglong * 8)()
    build.check(lib.ek_prof_read(out), "read")
    steps = chase.n_steps(n, b)
    per_step = [out[i] / steps for i in range(8)]
    return (per_step[:len(SEGMENTS)], per_step[len(SEGMENTS):], steps,
            lb[:n, 2 * b].clone())


def main(argv) -> int:
    n = int(argv[0]) if argv else 16384
    b = int(argv[1]) if len(argv) > 1 else 64
    path = argv[2] if len(argv) > 2 else ""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    with tempfile.TemporaryDirectory() as tmp:
        lib = _build(tmp, path)
        for dtype in (torch.float64, torch.float32):
            band_m = band.to_band(torch.tensor(a, dtype=dtype, device=dev),
                                  b).band
            ref = chase.band_to_tridiag(band_m, b)
            torch.cuda.synchronize()
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            t0.record()
            chase.band_to_tridiag(band_m, b)
            t1.record()
            torch.cuda.synchronize()
            ms = t0.elapsed_time(t1)
            cyc, extra, steps, d = profile(lib, band_m, b)
            err = float((d - ref.d).abs().max())
            print(f"{dtype}: n={n} b={b} {steps} steps, kernel {ms:.3f} ms "
                  f"({1e3 * ms / steps:.3f} us per step; {chase.BRANCH} "
                  f"branch, {chase.GRID} CTAs); profiled d - kernel d "
                  f"{err:.2e}; CTA 0 cycles per step: "
                  + ", ".join(f"{name} {c:.0f}"
                              for name, c in zip(SEGMENTS, cyc))
                  + f"; total {sum(cyc):.0f}"
                  + "".join(f"; probe {i} {c:.0f}"
                            for i, c in enumerate(extra, len(SEGMENTS))
                            if c))
            del band_m
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
