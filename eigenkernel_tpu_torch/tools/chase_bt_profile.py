"""Where a call of the WY-block back-transform (B5) spends its time.

    python -m eigenkernel_tpu_torch.tools.chase_bt_profile [n] [k]

Reduces a random symmetric matrix (seed 4) of order n (4096) to its band
(b = 64) and chases it with the port's kernels, then, on those reflectors
and a random z of k (500) columns, in float64 and float32, for each
sweep group g of 16, 32 and 64 and column tiles of 4, 8 and 16: the
call's time (CUDA events, median of 3 batches of 3 calls), the time of each of
its two launches (the factors and the walk over the blocks, from
torch.profiler), the blocks a CTA walks, µs a block and the largest
deviation from the plain version; and the cycles CTA 0 of an instrumented
copy of ``csrc/chase_bt.cu`` spends a block in each segment of the walk,
at the plan's tile width.
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

from eigenkernel_tpu_torch.ops import backtransform, band, build, bulge, chase

SEGMENTS = ("wait + barrier", "store b rows + issue loads", "Y^T z",
            "wait T^T + barrier", "-T^T W", "barrier + issue T^T",
            "z += Y W", "group end")

_PROBE = r"""
__device__ unsigned long long ek_prof[10];
__device__ long long ek_t0;
#define EK_MINE (blockIdx.x == 0)
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

# (anchor, text inserted after it), each anchor once in the source
_EDITS = (
    ("namespace {\n", _PROBE),
    ("  unsigned vphase = 0, tphase = 0;   // the parity each barrier waits "
     "for\n",
     "  if (EK_MINE && threadIdx.x == 0) ek_t0 = clock64();\n"),
    ("      vphase ^= 1u << buf;\n    }\n    __syncthreads();\n",
     "    EK_PROBE(0);\n    if (EK_MINE && threadIdx.x == 0) ++ek_prof[8];\n"),
    ("      if (same) load_z(row0 + L, b);\n    }\n    cp_async_commit();\n",
     "    EK_PROBE(1);\n"),
    ("        if (sl == 0) *reinterpret_cast<float4*>(wp + i * SZ + cq) = acc;"
     "\n      }\n    }\n",
     "    EK_PROBE(2);\n"),
    ("    tphase ^= 1u;\n    __syncthreads();\n", "    EK_PROBE(3);\n"),
    ("              make_float4(-acc.x, -acc.y, -acc.z, -acc.w);\n      }\n    }\n",
     "    EK_PROBE(4);\n"),
    ("    if (has_next) load_t(Gn, tn);\n",
     "    EK_PROBE(5);\n"),
    ("                            old.w + acc.w);\n        }\n      }\n    }\n",
     "    EK_PROBE(6);\n"),
    ("        load_z(basen, L);\n        cp_async_commit();\n      }\n    }\n",
     "    EK_PROBE(7);\n"),
)

_READ = r"""
extern "C" int ek_prof_read(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, ek_prof,
                                               sizeof(ek_prof)));
}
extern "C" int ek_prof_reset() {
  unsigned long long z[10] = {};
  return static_cast<int>(cudaMemcpyToSymbol(ek_prof, z, sizeof(z)));
}
"""


def instrumented_source() -> str:
    with open(os.path.join(build.CSRC, "chase_bt.cu")) as f:
        src = f.read()
    for anchor, text in _EDITS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in chase_bt.cu: "
                               f"{anchor!r}")
        src = src.replace(anchor, anchor + text)
    return src + _READ


def time_ms(fn, reps: int = 3, batches: int = 3) -> float:
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


def launch_ms(fn) -> dict:
    """Device ms of each kernel in one call of ``fn``, by torch.profiler
    (empty where the profiler sees no device time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        name = ev.key
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        for part in ("chase_bt_factor", "chase_bt_apply"):
            if part in name and us:
                out[part] = out.get(part, 0.0) + us / 1e3
    return out


def main(argv) -> int:
    n = int(argv[0]) if argv else 4096
    k = int(argv[1]) if len(argv) > 1 else 500
    b = 64
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True,
                         check=True).stdout.strip())
    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    a_np = rng.standard_normal((n, n))
    a_np = (a_np + a_np.T) / 2
    z_np = rng.standard_normal((n, k))
    prof_lib = None
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in (torch.float64, torch.float32):
            tag = "f64" if dtype == torch.float64 else "f32"
            res = chase.band_to_tridiag(band.to_band(torch.tensor(
                a_np, dtype=dtype, device=dev), b).band, b)
            z = torch.tensor(z_np, dtype=dtype, device=dev)
            ref = bulge.apply_chase_q(res, z)
            zs = float(ref.abs().max())
            for g in (16, 32, 64):
                for nc in (4, 8, 16):
                    def run():
                        return backtransform._launch(res, z, g, nc)
                    err = float((run() - ref).abs().max()) / zs
                    pl = backtransform.plan_of(
                        n, b, res.HV.shape[1], k, z.element_size(), g, nc,
                        torch.cuda.get_device_properties(
                            dev).multi_processor_count)
                    ms = time_ms(run)
                    parts = launch_ms(run)
                    split = ", ".join(f"{key[9:]} {val:.3f} ms" for key, val
                                      in parts.items()) or "not measured"
                    print(f"{tag} n={n} k={k} b={b} g={pl.g} tile {pl.nc}: "
                          f"{pl.ctas} CTAs, {pl.blocks} blocks, {ms:.3f} ms "
                          f"({1e3 * ms / pl.blocks:.3f} us a block; {split}),"
                          f" max |dz| / max |z| {err:.2e}", flush=True)
            # the instrumented walk at the plan's own tile width
            if prof_lib is None:
                src = os.path.join(tmp, "chase_bt_prof.cu")
                prof_lib = os.path.join(tmp, "libchase_bt_prof.so")
                with open(src, "w") as f:
                    f.write(instrumented_source())
                subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o",
                                prof_lib, src], check=True,
                               capture_output=True)
                lib = ctypes.CDLL(prof_lib)
            name = "ek_chase_bt_" + tag
            fn = getattr(lib, name)
            fn.argtypes = list(build._SIGNATURES["chase_bt.cu"][name])
            for g in (32, 64):
                pl = backtransform.plan_of(
                    n, b, res.HV.shape[1], k, z.element_size(), g,
                    sms=torch.cuda.get_device_properties(
                        dev).multi_processor_count)
                tf = z.new_empty((pl.nG * pl.T * pl.gp * (pl.gp + 4),))
                out = z.clone()
                build.check(lib.ek_prof_reset(), "reset")
                build.check(fn(res.HV.data_ptr(), res.HT.data_ptr(),
                               tf.data_ptr(), out.data_ptr(), n, k, pl.T, b,
                               pl.g, pl.nc,
                               torch.cuda.current_stream().cuda_stream),
                            name)
                torch.cuda.synchronize()
                cyc = (ctypes.c_ulonglong * 10)()
                build.check(lib.ek_prof_read(cyc), "read")
                blocks = max(cyc[8], 1)
                total = sum(cyc[i] for i in range(len(SEGMENTS)))
                print(f"{tag} g={pl.g} tile {pl.nc}, CTA 0: {cyc[8]} blocks, "
                      f"{total / blocks:.0f} cycles a block: " + ", ".join(
                          f"{seg} {cyc[i] / blocks:.0f}"
                          for i, seg in enumerate(SEGMENTS)), flush=True)
            del res, z, ref
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
