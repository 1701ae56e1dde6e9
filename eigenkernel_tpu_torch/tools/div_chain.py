"""Latency of one dependent step of the division recurrences on the card.

    python -m eigenkernel_tpu_torch.tools.div_chain

Builds a small CUDA program with nvcc and runs it: one warp runs a long
chain of one recurrence with its operands in registers, timed by
``clock64`` (cycles) and by CUDA events (ms, hence the clock the card ran
at).  The recurrences, in the arithmetic of their kernels:

* ``sturm``: B1's count step (``csrc/sturm_bisect.cu``),
  ``q = (d - x) - e2 / q`` with the pivmin floor and the count, with 1, 2
  or 4 independent chains in one thread (the cycles per step are those of
  one step of every chain), and with one chain a thread in 1 to 32 warps
  on every SM at once (the cycles per step of one warp when that many
  share the SM: the kernel's blocks of W warps a target);
* ``solve_fwd``: B2's forward row (``csrc/tridiag_solve.cu``),
  ``l = e / u``, ``u = (d - lam) - e l`` floored, ``y = b - l y``;
* ``solve_bwd``: B2's backward row, ``x = (y - e x) / u``;
* ``deflate``: D1's step (``csrc/dc_deflate.cu``), ``r = sqrt(up^2 +
  u^2)``, ``c = u / r``, ``s = up / r``, the coupling test and the rotated
  carry;
* ``pair_set``: one set of D2 (``csrc/pair_jacobi.cu``): the skip test and
  the rotation (tau, t, c, s: two square roots and three divisions in a
  row), then a row and a column update that feed the next set's a_pq,
  with D2's three block barriers (in a block of one warp, their least
  cost);

in float64 and float32.  A kernel's chain floor is its serial steps per
thread times this latency: what a serial recurrence allows however wide
the card.  The tool ends by printing the floors of B1 and B2 at the
selecting path's shapes (k = 500 targets at n = 4096 and 16384): B1 runs
ceil(iters / depth) passes of n steps (the depth its ``warps_per_target``
gives on this card; one-step bisection, iters passes, beside it), B2 one
forward and one backward row a row, at the clock the chain ran at;
D1's at n = 4096 and 16384 for the full spectrum: the top merge of every
level of the divide-and-conquer tree, K = 2 base 2^(l-1) steps; and D2's
for one sweep of a 128 x 128 pair block, 127 sets.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile

from eigenkernel_tpu_torch.ops import build, dc, sturm

SOURCE = r"""
#include <cstdio>
#include <limits>
#include <cuda_runtime.h>

__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }

// 8 operand sets cycled in registers: d in v[0..8), e2 / e in v[8..16),
// b / y / u in v[16..24), x / lam in v[24..28)
template <typename T, int kind, int C>
__global__ void chain(const T* __restrict__ v, T* out, long long* cyc,
                      int steps, T pivmin) {
  T dv[8], ev[8], bv[8], x[C], q[C];
  int c[C];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    dv[u] = v[u];
    ev[u] = v[8 + u];
    bv[u] = v[16 + u];
  }
#pragma unroll
  for (int a = 0; a < C; ++a) {
    x[a] = v[24 + a];
    q[a] = kind == 2 ? T(0) : T(1);
    c[a] = 0;
  }
  T y = T(0);
  __syncwarp();
  const long long t0 = clock64();
  for (int i = 0; i < steps; i += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (kind == 0) {
#pragma unroll
        for (int a = 0; a < C; ++a) {
          T qa = (dv[u] - x[a]) - ev[u] / q[a];
          if (fabs(qa) < pivmin) qa = (qa < T(0)) ? -pivmin : pivmin;
          c[a] += (qa < T(0)) ? 1 : 0;
          q[a] = qa;
        }
      } else if (kind == 1) {
        const T l = ev[u] / q[0];
        T ui = (dv[u] - x[0]) - mul_rn(ev[u], l);
        if (fabs(ui) < pivmin) ui = (ui < T(0)) ? -pivmin : pivmin;
        y = bv[u] - mul_rn(l, y);
        q[0] = ui;
      } else if (kind == 2) {
        q[0] = (dv[u] - mul_rn(ev[u], q[0])) / bv[u];
      } else if (kind == 3) {
        // D1: the carry (dp, up) in (x[0], q[0]), pivmin as the tolerance
        const T di = dv[u], ui = ev[u];
        const T r = sqrt_rn(add_rn(mul_rn(q[0], q[0]), mul_rn(ui, ui)));
        const T rs = r == T(0) ? T(1) : r;
        const T cc = div_rn(ui, rs), sn = div_rn(q[0], rs);
        const bool close = fabs(mul_rn(mul_rn(di - x[0], cc), sn)) <= pivmin;
        x[0] = close ? add_rn(mul_rn(mul_rn(sn, sn), x[0]),
                              mul_rn(mul_rn(cc, cc), di))
                     : di;
        q[0] = close ? r : ui;
      } else {
        // D2: a_pp, a_qq in dv, bv; a_pq carried in q[0]; the rows' and
        // columns' other entries in ev, x[0]
        const T app = dv[u], aqq = bv[u], apq = q[0];
        const T thr = mul_rn(pivmin, sqrt_rn(fabs(mul_rn(app, aqq))));
        T cc = T(1), sn = T(0);
        if (fabs(apq) > thr) {
          const T tau = div_rn(aqq - app, mul_rn(T(2), apq));
          const T sg = tau >= T(0) ? T(1) : T(-1);
          const T t = div_rn(sg, add_rn(fabs(tau),
                                        sqrt_rn(add_rn(T(1),
                                                       mul_rn(tau, tau)))));
          cc = div_rn(T(1), sqrt_rn(add_rn(T(1), mul_rn(t, t))));
          sn = mul_rn(t, cc);
        }
        __syncthreads();
        const T row = mul_rn(cc, ev[u]) - mul_rn(sn, x[0]);
        __syncthreads();
        const T col = mul_rn(sn, row) + mul_rn(cc, ev[u]);
        __syncthreads();
        q[0] = add_rn(mul_rn(T(0.5), col), T(0.75));
      }
    }
  }
  const long long t1 = clock64();
  T s = y;
#pragma unroll
  for (int a = 0; a < C; ++a) s += q[a] + T(c[a]);
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (blockIdx.x == 0 && threadIdx.x == 0) *cyc = t1 - t0;
}

template <typename T, int kind, int C>
int run(const char* name, const char* type, const T* vals, int blocks,
        int warps) {
  const int steps = 1 << 18, threads = 32 * warps;
  const T pivmin = T(4) * std::numeric_limits<T>::min();
  T *v, *out;
  long long* cyc;
  if (cudaMalloc(&v, 28 * sizeof(T)) ||
      cudaMalloc(&out, sizeof(T) * blocks * threads) ||
      cudaMalloc(&cyc, sizeof(long long)))
    return 1;
  cudaMemcpy(v, vals, 28 * sizeof(T), cudaMemcpyHostToDevice);
  chain<T, kind, C><<<blocks, threads>>>(v, out, cyc, 64, pivmin);
  cudaEvent_t s, e;
  cudaEventCreate(&s);
  cudaEventCreate(&e);
  cudaEventRecord(s);
  chain<T, kind, C><<<blocks, threads>>>(v, out, cyc, steps, pivmin);
  cudaEventRecord(e);
  cudaEventSynchronize(e);
  const cudaError_t err = cudaGetLastError();
  float ms = 0;
  cudaEventElapsedTime(&ms, s, e);
  long long cycles = 0;
  cudaMemcpy(&cycles, cyc, sizeof(long long), cudaMemcpyDeviceToHost);
  printf("%s %s chains=%d blocks=%d warps=%d: %.2f cycles/step (%lld "
         "cycles in %.3f ms, %.0f MHz) (%s)\n", name, type, C, blocks, warps,
         static_cast<double>(cycles) / steps, cycles, ms,
         cycles / (ms * 1e3), cudaGetErrorString(err));
  cudaFree(v);
  cudaFree(out);
  cudaFree(cyc);
  return err != cudaSuccess;
}

template <typename T>
int all(const char* type, int sms) {
  // d and x inside a spectrum of width ~6, e2 = e^2 of O(1) couplings;
  // solve_bwd divides by u in v[16..24), |u| >= 2, |e| <= 1.6
  const T vals[28] = {0.3, -1.2, 0.8, 1.9, -0.4, 0.1, -2.2, 1.1,
                      0.5, 1.3, 0.2, 0.9, 0.7, 1.6, 0.05, 0.4,
                      2.5, -3.1, 2.2, 4.0, -2.6, 3.3, -2.05, 2.9,
                      0.12, -0.37, 0.61, -0.93};
  int bad = run<T, 0, 1>("sturm", type, vals, 1, 1) |
            run<T, 0, 2>("sturm", type, vals, 1, 1) |
            run<T, 0, 4>("sturm", type, vals, 1, 1) |
            run<T, 1, 1>("solve_fwd", type, vals, 1, 1) |
            run<T, 2, 1>("solve_bwd", type, vals, 1, 1) |
            run<T, 3, 1>("deflate", type, vals, 1, 1) |
            run<T, 4, 1>("pair_set", type, vals, 1, 1);
  for (int warps = 1; warps <= 32; warps *= 2)
    bad |= run<T, 0, 1>("sturm", type, vals, sms, warps);
  return bad;
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  return all<double>("f64", sms) | all<float>("f32", sms);
}
"""


def parse(out: str) -> dict:
    """{(recurrence, "f64" | "f32"): (cycles a step, MHz)} of the
    one-warp, one-chain runs in the tool's output."""
    return {(m[1], m[2]): (float(m[3]), float(m[4])) for m in re.finditer(
        r"^(\w+) (f64|f32) chains=1 blocks=1 warps=1: ([0-9.]+) "
        r"cycles/step .*?, ([0-9.]+) MHz", out, re.M)}


def dc_top_steps(n: int) -> int:
    """D1's chain at n: the steps of the top merge of every level of the
    divide-and-conquer tree (``ops/dc.py::_tree_shape``), one launch a
    level."""
    base, levels = dc._tree_shape(n)
    return sum(2 * base << (lvl - 1) for lvl in range(1, levels + 1))


def step_ns(chains: dict, name: str, tag: str) -> float:
    cyc, mhz = chains[name, tag]
    return 1e3 * cyc / mhz


def floors(out: str, sms: int) -> None:
    """Print the chain floors of B1, B2 and D1 from the tool's output."""
    chains = parse(out)
    k = 500
    warps = sturm.warps_per_target(k, sms)
    for n in (4096, 16384):
        for tag, iters in (("f64", 62), ("f32", 30)):
            passes = len(sturm.round_depths(iters, sturm.depth_of(warps)))
            b1 = passes * n * step_ns(chains, "sturm", tag) / 1e6
            seq = iters * n * step_ns(chains, "sturm", tag) / 1e6
            b2 = n * (step_ns(chains, "solve_fwd", tag)
                      + step_ns(chains, "solve_bwd", tag)) / 1e6
            d1 = dc_top_steps(n) * step_ns(chains, "deflate", tag) / 1e6
            print(f"chain floor {tag} n={n} k={k}: B1 {b1:.3f} ms ({passes} "
                  f"passes of {n} steps at {warps} warps a target; one-step "
                  f"bisection {seq:.3f} ms), B2 {b2:.3f} ms ({n} forward + "
                  f"{n} backward rows); D1 {d1:.3f} ms over the levels of "
                  f"the full spectrum ({dc_top_steps(n)} top-merge steps)")
    for tag in ("f64", "f32"):
        w = 128                   # the pair blocks of the default panel
        d2 = (w - 1) * step_ns(chains, "pair_set", tag) / 1e6
        print(f"chain floor {tag}: D2 {d2:.4f} ms a sweep of a {w} x {w} "
              f"pair block ({w - 1} dependent sets)")


def run_chains() -> str:
    """Build the chain program with nvcc, run it, return its output."""
    with tempfile.TemporaryDirectory() as tmp:
        src, exe = os.path.join(tmp, "chain.cu"), os.path.join(tmp, "chain")
        with open(src, "w") as f:
            f.write(SOURCE)
        flags = [x for x in build.NVCC_FLAGS if x not in ("-shared",
                                                          "-Xcompiler",
                                                          "-fPIC")]
        subprocess.run([build._nvcc(), *flags, "-o", exe, src], check=True,
                       capture_output=True)
        run = subprocess.run([exe], capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"chain program failed ({run.returncode}): "
                           f"{run.stdout}{run.stderr}")
    return run.stdout


def main() -> int:
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = run_chains()
    print(out, end="")
    floors(out, sms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
