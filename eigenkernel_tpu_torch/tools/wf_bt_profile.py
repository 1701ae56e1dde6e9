"""Where a launch of the composite back-transform kernel (B4) spends its
time, float64, resident branch.

    python -m eigenkernel_tpu_torch.tools.wf_bt_profile [n] [k]

Builds the plan of the two-stage path at n (16384) and k (500) columns
with b = g = 64, fills the first phase of the P stream and z with random
numbers (seed 0; the kernel's time does not depend on the values), and
prints the card and, for that phase: the launches and live lane-steps,
the kernel time per launch from one call of the kernel's host loop (CUDA
events), the bound per launch (``obs/flops.py``), the time the launch's
windows of z (in and out) and P (in) take at the memory rate (the floor of
a schedule that streams z from device memory at every composite step),
and the cycles CTA
(0, 0) of an instrumented copy of ``csrc/wf_bt.cu`` spends per z tile in
each segment: issuing the next tile's copies, the DMMA loop with its waits
for the data (the first tile waits for P quarter by quarter), and the
stores with the closing barrier.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import torch

from eigenkernel_tpu_torch.obs import flops
from eigenkernel_tpu_torch.ops import build, chase, wf_bt

SEGMENTS = ("issue", "wait + dmma", "store")

_PROBE = r"""
__device__ unsigned long long ek_prof[8];
__device__ long long ek_t0;
#define EK_MINE (blockIdx.x == 0 && blockIdx.y == 0)
#define EK_PROBE(k)                                       \
  do {                                                    \
    if (EK_MINE) {                                        \
      __syncthreads();                                    \
      if (threadIdx.x == 0) {                             \
        const long long t_ = clock64();                   \
        ek_prof[k] += t_ - ek_t0;                         \
        ek_t0 = t_;                                       \
      }                                                   \
    }                                                     \
  } while (0)
"""

_EDITS = (
    ("namespace {\n", _PROBE),
    ("                       double* __restrict__ zp, int k, int s2, "
     "int row_base,\n                       int g_lo) {\n",
     "  if (EK_MINE && threadIdx.x == 0) ek_t0 = clock64();\n"
     "  if (EK_MINE && threadIdx.x == 0) ++ek_prof[7];\n"),
    ("    double acc[2][2][4] = {};\n    const double* zb = zs + (it & 1) * "
     "s2r * SZ + fk * SZ + wc * 16 + fr;\n", "    EK_PROBE(0);\n"),
    ("        warp_k4<2>(acc, pa + kk, SP, zb + kk * SZ);\n    }\n",
     "    EK_PROBE(1);\n"),
    ("    __syncthreads();   // the buffer is refilled by the next pass\n",
     "    EK_PROBE(2);\n    if (EK_MINE && threadIdx.x == 0) "
     "++ek_prof[6];\n"),
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


def instrumented_source() -> str:
    with open(os.path.join(build.CSRC, "wf_bt.cu")) as f:
        src = f.read()
    for anchor, text in _EDITS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in wf_bt.cu: "
                               f"{anchor!r}")
        src = src.replace(anchor, anchor + text)
    return src + _READ


def main(argv) -> int:
    n = int(argv[0]) if argv else 16384
    k = int(argv[1]) if len(argv) > 1 else 500
    b = g = 64
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    dtype = torch.float64
    pl = wf_bt.plan_of(n, b, chase.n_positions(n, b), 8, g)
    S2 = pl.g + pl.m * pl.b
    gen = torch.Generator(device=dev).manual_seed(0)
    P = torch.randn((pl.tc, pl.nG, S2, S2), dtype=dtype, device=dev,
                    generator=gen) / S2 ** 0.5
    zp = torch.randn((pl.rows, k), dtype=dtype, device=dev, generator=gen)
    launches, steps = flops.wf_bt_lane_steps(pl, 0, pl.tc)
    bound_ms = flops.bound_wf_bt(n, k, b, g, dtype, 0, pl.tc)[0]
    wf_bt.apply_phase(P, zp, pl, 0)           # warm-up (builds the kernels)
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    torch.cuda.synchronize()
    t0.record()
    wf_bt.apply_phase(P, zp, pl, 0)
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1)
    # one launch per composite step streams each live window of z in and
    # out of device memory, and its P in: the floor of this schedule
    nbytes = steps * (2 * S2 * k + S2 * S2) * 8
    print(f"n={n} k={k} b=g={b} S2={S2}: phase 1 of {pl.nph}, {launches} "
          f"launches, {steps} lane-steps ({wf_bt.BRANCH} branch): "
          f"{1e3 * ms / launches:.2f} us per launch against a bound of "
          f"{1e3 * bound_ms / launches:.2f} us; the windows of z in and out "
          f"and P in, {nbytes / launches / 1e6:.1f} MB per launch, take "
          f"{1e6 * nbytes / launches / flops.MEM_RATE:.2f} us at "
          f"{flops.MEM_RATE / 1e12:.2f} TB/s")
    with tempfile.TemporaryDirectory() as tmp:
        src, lib_path = (os.path.join(tmp, "wf_bt_prof.cu"),
                         os.path.join(tmp, "libwf_bt_prof.so"))
        with open(src, "w") as f:
            f.write(instrumented_source())
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib_path,
                        src], check=True, capture_output=True)
        lib = ctypes.CDLL(lib_path)
        fn = lib.ek_wf_bt_f64
        fn.argtypes = list(build._SIGNATURES["wf_bt.cu"]["ek_wf_bt_f64"])
        build.check(lib.ek_prof_reset(), "reset")
        launched, resident = ctypes.c_int(0), ctypes.c_int(0)
        build.check(fn(P.data_ptr(), zp.data_ptr(), k, pl.n, pl.b, pl.g,
                       pl.m, pl.nG, pl.Tm, pl.top, 0, pl.tc,
                       ctypes.byref(launched), ctypes.byref(resident),
                       torch.cuda.current_stream().cuda_stream), "wf_bt")
        torch.cuda.synchronize()
        out = (ctypes.c_ulonglong * 8)()
        build.check(lib.ek_prof_read(out), "read")
    tiles, ctas = out[6], out[7]
    print(f"CTA (0, 0): {ctas} launches, {tiles / max(ctas, 1):.1f} z tiles "
          f"each; cycles per tile: "
          + ", ".join(f"{name} {out[i] / max(tiles, 1):.0f}"
                      for i, name in enumerate(SEGMENTS)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
