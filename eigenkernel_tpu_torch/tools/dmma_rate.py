"""Issue rate of the FP64 tensor-core (DMMA) shapes on the card.

    python -m eigenkernel_tpu_torch.tools.dmma_rate

Builds a small CUDA program with nvcc and runs it: two CTAs per SM, each
warp issuing chains of independent ``mma.sync`` f64 products of one shape
(m8n8k4, m16n8k4, m16n8k8, m16n8k16) from registers, timed with CUDA
events.  It prints the card and the TFLOP/s of each shape: the rate the
composite back-transform (``csrc/wf_bt.cu``) can reach with that shape.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

from eigenkernel_tpu_torch.ops import build

SOURCE = r"""
#include <cstdio>
#include <cuda_runtime.h>

template <int M, int K>
__global__ void rate(double* out, int iters) {
  constexpr int NA = M * K / 32, NC = M * 8 / 32, NB = K / 4;
  double a[NA], b[NB], c[8][NC] = {};
  for (int q = 0; q < NA; ++q) a[q] = threadIdx.x * 1e-3 + q;
  for (int q = 0; q < NB; ++q) b[q] = 1.0 + threadIdx.x * 1e-4 + q;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (M == 8)
        asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
                     "{%0,%1}, {%2}, {%3}, {%0,%1};\n"
                     : "+d"(c[j][0]), "+d"(c[j][1]) : "d"(a[0]), "d"(b[0]));
      else if constexpr (K == 4)
        asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
                     "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
                     : "+d"(c[j][0]), "+d"(c[j][1]), "+d"(c[j][2]),
                       "+d"(c[j][3])
                     : "d"(a[0]), "d"(a[1]), "d"(b[0]));
      else if constexpr (K == 8)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+d"(c[j][0]), "+d"(c[j][1]), "+d"(c[j][2]),
                       "+d"(c[j][3])
                     : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]),
                       "d"(b[0]), "d"(b[1]));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, "
                     "{%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
                     : "+d"(c[j][0]), "+d"(c[j][1]), "+d"(c[j][2]),
                       "+d"(c[j][3])
                     : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]),
                       "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
                       "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
    }
  }
  double s = 0;
  for (int j = 0; j < 8; ++j)
    for (int q = 0; q < NC; ++q) s += c[j][q];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int M, int K>
int run(const char* name, int sms) {
  const int blocks = 2 * sms, threads = 256, iters = 4096;
  double* out;
  if (cudaMalloc(&out, sizeof(double) * blocks * threads)) return 1;
  rate<M, K><<<blocks, threads>>>(out, 16);
  cudaEvent_t s, e;
  cudaEventCreate(&s);
  cudaEventCreate(&e);
  cudaEventRecord(s);
  rate<M, K><<<blocks, threads>>>(out, iters);
  cudaEventRecord(e);
  cudaEventSynchronize(e);
  const cudaError_t err = cudaGetLastError();
  float ms = 0;
  cudaEventElapsedTime(&ms, s, e);
  const double flops = 2.0 * M * 8 * K * 8 * iters * (threads / 32) * blocks;
  printf("%s: %.3f ms, %.1f TFLOP/s (%s)\n", name, ms, flops / ms / 1e9,
         cudaGetErrorString(err));
  cudaFree(out);
  return err != cudaSuccess;
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  return run<8, 4>("m8n8k4", sms) | run<16, 4>("m16n8k4", sms) |
         run<16, 8>("m16n8k8", sms) | run<16, 16>("m16n8k16", sms);
}
"""


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    with tempfile.TemporaryDirectory() as tmp:
        src, exe = os.path.join(tmp, "rate.cu"), os.path.join(tmp, "rate")
        with open(src, "w") as f:
            f.write(SOURCE)
        flags = [x for x in build.NVCC_FLAGS if x not in ("-shared",
                                                          "-Xcompiler",
                                                          "-fPIC")]
        subprocess.run([build._nvcc(), *flags, "-o", exe, src], check=True)
        return subprocess.run([exe]).returncode


if __name__ == "__main__":
    sys.exit(main())
