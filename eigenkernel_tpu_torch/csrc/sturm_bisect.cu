// Batched Sturm-count bisection for eigenvalues of a symmetric tridiagonal
// matrix, one thread per target eigenvalue.
//
// Replaces: eigenkernel_tpu/ops/pallas_sturm.py::sturm_bisect (Pallas kernel
// _sturm_bisect_kernel), which tiles the targets into (8, 128) VMEM blocks.
//
// Computes lambda_{idx[t]} of tridiag(d, e) by `iters` bisection steps on
// [bounds[0], bounds[1]].  Each step runs the dstebz/dlaneg count
//
//     q_i = (d_i - x) - e_{i-1}^2 / q_{i-1},   |q_i| floored at pivmin,
//     count += (q_i < 0),
//
// with pivmin = 4 * numeric_limits<T>::min() and the target convention
// count >= idx + 1  =>  lambda_idx < x  =>  hi = x.
//
// What bounds it on the card: the latency of the serial division chain,
// iters * n dependent steps per thread (62 * n in float64, 30 * n in
// float32).  Memory traffic is tiny: every thread reads the same d_i and
// e2_i in lockstep, so each load is one broadcast through the read-only
// cache.  At k = 500 targets the grid is only 4 blocks of 128 threads, so
// most SMs idle.
//
// What the design does about it: nothing yet beyond keeping the chain
// short (one division, one subtraction and one compare per step) and the
// operands in registers.  Multisection (several candidate points per
// target, one thread each) and a staged shared-memory chunk of d / e2 are
// the next steps; this first version is the plain, right one.

#include <cuda_runtime.h>

#include <limits>

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void sturm_bisect_kernel(const T* __restrict__ d,
                                    const T* __restrict__ e2,
                                    const int* __restrict__ idx,
                                    const T* __restrict__ bounds,
                                    T* __restrict__ out, int n, int k,
                                    int iters, T pivmin) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= k) return;
  const int target = idx[t] + 1;
  T lo = bounds[0];
  T hi = bounds[1];
  for (int it = 0; it < iters; ++it) {
    const T mid = T(0.5) * (lo + hi);
    T q = T(1);
    int cnt = 0;
    for (int i = 0; i < n; ++i) {
      q = (__ldg(d + i) - mid) - __ldg(e2 + i) / q;
      if (fabs(q) < pivmin) q = (q < T(0)) ? -pivmin : pivmin;
      cnt += (q < T(0)) ? 1 : 0;
    }
    if (cnt >= target) {
      hi = mid;
    } else {
      lo = mid;
    }
  }
  out[t] = T(0.5) * (lo + hi);
}

template <typename T>
int launch(const void* d, const void* e2, const void* idx,
           const void* bounds, void* out, int n, int k, int iters,
           void* stream) {
  const int blocks = (k + kThreads - 1) / kThreads;
  const T pivmin = T(4) * std::numeric_limits<T>::min();
  sturm_bisect_kernel<T><<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(d), static_cast<const T*>(e2),
      static_cast<const int*>(idx), static_cast<const T*>(bounds),
      static_cast<T*>(out), n, k, iters, pivmin);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// e2 has n entries: e2[0] = 0 and e2[i] = e[i-1]^2.  bounds holds (lo, hi)
// on the device.  Returns cudaGetLastError() after the launch.
extern "C" int ek_sturm_bisect_f64(const void* d, const void* e2,
                                   const void* idx, const void* bounds,
                                   void* out, int n, int k, int iters,
                                   void* stream) {
  return launch<double>(d, e2, idx, bounds, out, n, k, iters, stream);
}

extern "C" int ek_sturm_bisect_f32(const void* d, const void* e2,
                                   const void* idx, const void* bounds,
                                   void* out, int n, int k, int iters,
                                   void* stream) {
  return launch<float>(d, e2, idx, bounds, out, n, k, iters, stream);
}
