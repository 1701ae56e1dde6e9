// Batched shifted tridiagonal solves (T - lam_j I) x_j = b_j, the inner
// step of inverse iteration, one thread per system j.
//
// Replaces: eigenkernel_tpu/ops/pallas_solve.py::tridiag_solve_pallas
// (Pallas kernel _solve_kernel), which pads n to 256-row chunks and k to
// 1024-lane tiles and streams u, y and x through HBM scratch.
//
// Recurrences (LU without pivoting, dstein-style pivot floor):
//   forward:  l = e_{i-1} / u_{i-1}
//             u_i = (d_i - lam) - e_{i-1} l,   |u_i| floored at +-tiny
//             y_i = b_i - l y_{i-1}
//   backward: x_i = (y_i - e_i x_{i+1}) / u_i
// The pivot floor `tiny` is an argument: inverse iteration passes
// eps * max|T| as LAPACK's dstein does, where the Pallas kernel fixes
// 1e-30 (float64) / 1e-25 (float32).  An absolute 1e-30 lets a shift
// that zeroes a leading minor exactly (glued Wilkinson matrices) grow
// multipliers of 1e30, and the rounding of that growth swamps the
// eigenvector.
// Products are rounded on their own (mul_rn), never fused into an FMA with
// the following subtraction: the kernel then rounds exactly as its plain
// PyTorch version, which matters in float32, where a near-singular shift
// amplifies a one-ulp difference in a pivot to 1e-4 in the solution.
//
// Layout: b, u, y and x are (n, k) row-major, so row i is contiguous across
// systems and the 32 threads of a warp touch 32 neighbouring words: every
// load and store coalesces.  d and e are read by all threads in lockstep
// (broadcast through the read-only cache).
//
// What bounds it on the card: memory, about 6 * n * k * itemsize bytes
// (read b, write u and y, read u and y, write x).  Each row of a sweep is
// also a dependent step, so at small k the latency of the division chain
// shows.  What the design does about it: coalesced row access and no
// padding.  Keeping u and y in registers or shared memory for a chunk of
// rows (as the Pallas kernel kept them in VMEM) would cut the traffic to
// 2 * n * k * itemsize; that is later work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}

template <typename T>
__global__ void tridiag_solve_kernel(const T* __restrict__ d,
                                     const T* __restrict__ e,
                                     const T* __restrict__ lam,
                                     const T* __restrict__ b,
                                     T* __restrict__ u, T* __restrict__ y,
                                     T* __restrict__ x, int n, int k,
                                     T tiny) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= k) return;
  const T lj = lam[j];
  const size_t ld = static_cast<size_t>(k);
  T u_prev = T(1);
  T y_prev = T(0);
  for (int i = 0; i < n; ++i) {
    const size_t at = static_cast<size_t>(i) * ld + j;
    const T el = (i == 0) ? T(0) : __ldg(e + i - 1);
    const T l = el / u_prev;
    T ui = (__ldg(d + i) - lj) - mul_rn(el, l);
    if (fabs(ui) < tiny) ui = (ui < T(0)) ? -tiny : tiny;
    const T yi = b[at] - mul_rn(l, y_prev);
    u[at] = ui;
    y[at] = yi;
    u_prev = ui;
    y_prev = yi;
  }
  T x_next = T(0);
  for (int i = n - 1; i >= 0; --i) {
    const size_t at = static_cast<size_t>(i) * ld + j;
    const T er = (i == n - 1) ? T(0) : __ldg(e + i);
    const T xi = (y[at] - mul_rn(er, x_next)) / u[at];
    x[at] = xi;
    x_next = xi;
  }
}

template <typename T>
int launch(const void* d, const void* e, const void* lam, const void* b,
           void* u, void* y, void* x, int n, int k, T tiny, void* stream) {
  const int blocks = (k + kThreads - 1) / kThreads;
  tridiag_solve_kernel<T><<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(d), static_cast<const T*>(e),
      static_cast<const T*>(lam), static_cast<const T*>(b),
      static_cast<T*>(u), static_cast<T*>(y), static_cast<T*>(x), n, k,
      tiny);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// d (n,), e (n-1,), lam (k,), b / u / y / x (n, k) row-major; u and y
// are scratch; tiny is the pivot floor.  Returns cudaGetLastError() after
// the launch.
extern "C" int ek_tridiag_solve_f64(const void* d, const void* e,
                                    const void* lam, const void* b, void* u,
                                    void* y, void* x, int n, int k,
                                    double tiny, void* stream) {
  return launch<double>(d, e, lam, b, u, y, x, n, k, tiny, stream);
}

extern "C" int ek_tridiag_solve_f32(const void* d, const void* e,
                                    const void* lam, const void* b, void* u,
                                    void* y, void* x, int n, int k,
                                    float tiny, void* stream) {
  return launch<float>(d, e, lam, b, u, y, x, n, k, tiny, stream);
}
