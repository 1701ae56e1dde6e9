// Band -> tridiagonal bulge chase (Lang/Schwarz Householder chasing) on the
// stagger-4 wavefront schedule: one launch per wavefront step tau, one CTA
// per live wavefront lane.
//
// Replaces: eigenkernel_tpu/ops/pallas_chase.py::band_to_tridiag_pallas
// (Pallas kernel _chase_kernel / _chase_group), which keeps the whole
// banded state resident in TPU VMEM and runs all ~4n steps as one grid.
//
// State: the lower half of the symmetric band matrix with the bulge
// margin, lb[i, q] = A[i, i + q - 2b], q in [0, 2b], row-major with
// W = 2b + 1 words per row and n + 2b rows (rows >= n are zero).
//
// Schedule (ops/chase.py): at step tau, lane j chases sweep
// c = tau/4 - j at band position t = tau%4 + 4j.  Its window starts at
// p = c + 1 + t b and touches rows [p, p + 2b) only; lanes sit 4b - 1 rows
// apart, so the lanes of one step touch disjoint rows and run as
// independent CTAs.  A lane is live when 0 <= c <= n-3, t < T, p < n-1 and
// jcol < n-1; a dead lane returns at once and writes nothing.
//
// One lane, in three phases separated by __syncthreads:
//   1. x = A[p:p+b, jcol] (jcol = c for t == 0, else p - b), the
//      Householder (I - tau v v^T) x = beta e_0 with v[0] = 1; write v and
//      tau to HV[c, t, :] and HT[c, t];
//   2. read every coefficient: dv = D v (D = A[p:p+b, p:p+b], symmetric,
//      read from its lower half), cl = v^T A[p:p+b, p-b-1:p] (left strip),
//      cr = A[p+b:p+2b, p:p+b] v (bulge fill rows), then vdv = v . dv;
//   3. write: D <- D - tau v dv^T - tau dv v^T + tau^2 vdv v v^T (lower
//      half; the diagonal corner A[p+b-1, p+b-1] is one of its entries),
//      left strip <- strip - tau v cl^T, fill rows <- fill - tau cr v^T.
// Every read of phase 2 happens before any write of phase 3.  tau == 0
// (a zero tail) is the identity, so such a lane stops after writing its
// (zero) reflector.
//
// What bounds it on the card: latency.  A lane moves about 6 b^2 words
// (b = 64: 24k words, the state of all lanes fits in the 50 MB L2 at
// n = 16384 in float64), and a step holds at most T/4 + 1 lanes, so most
// of the 132 SMs idle and each step costs a launch plus three dependent
// phases.  What the design does about it: no shared-memory window (any
// b >= 2 runs, at any dtype, in a few KB of shared memory), warp-per-output
// dot products for the phase-2 reductions, and the grid of each step
// covers only its live lane range.  A persistent kernel or a CUDA graph
// over the ~4n steps is later work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sum over the block; every thread gets the result.  `red` holds kWarps
// words of shared memory.
template <typename T>
__device__ T block_sum(T x, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_sum(x);
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  T s = T(0);
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

template <typename T>
__global__ void chase_step_kernel(T* __restrict__ lb, T* __restrict__ hv,
                                  T* __restrict__ ht, int n, int b, int nt,
                                  int tau, int j0) {
  const int j = j0 + blockIdx.x;
  const int t = (tau % 4) + 4 * j;
  const int c = tau / 4 - j;
  const int p = c + 1 + t * b;
  const int jcol = (t == 0) ? c : p - b;
  if (!(c >= 0 && c <= n - 3 && t <= nt - 1 && p < n - 1 && jcol < n - 1))
    return;

  extern __shared__ unsigned char smem_raw[];
  T* v = reinterpret_cast<T*>(smem_raw);   // (b,)
  T* dv = v + b;                           // (b,)
  T* cl = dv + b;                          // (b + 1,)
  T* cr = cl + b + 1;                      // (b,)
  T* red = cr + b;                         // (kWarps,)
  T* sc = red + kWarps;                    // tau, alpha - beta

  const int W = 2 * b + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // A[i, col] of the lower band storage (col <= i, i - col <= 2b)
  auto at = [&](int i, int col) -> T& {
    return lb[static_cast<size_t>(i) * W + (col - i + 2 * b)];
  };

  // ---- phase 1: the Householder of the pivot column
  T part = T(0);
  for (int r = tid; r < b; r += kThreads) {
    const T x = at(p + r, jcol);
    v[r] = x;
    if (r > 0) part += x * x;
  }
  const T sigma = block_sum(part, red);
  if (tid == 0) {
    const T alpha = v[0];
    T tau_h = T(0), denom = T(1);
    if (sigma != T(0)) {
      const T sgn = alpha >= T(0) ? T(1) : T(-1);
      const T beta = -sgn * sqrt(alpha * alpha + sigma);
      denom = alpha - beta;
      tau_h = (beta - alpha) / (beta == T(0) ? T(1) : beta);
    }
    sc[0] = tau_h;
    sc[1] = denom;
  }
  __syncthreads();
  const T th = sc[0];
  const bool live_v = sigma != T(0);
  T* hv_out = hv + (static_cast<size_t>(c) * nt + t) * b;
  for (int r = tid; r < b; r += kThreads) {
    const T vr = live_v ? (r == 0 ? T(1) : v[r] / sc[1]) : T(0);
    hv_out[r] = vr;
    v[r] = vr;
  }
  if (tid == 0) ht[static_cast<size_t>(c) * nt + t] = th;
  if (th == T(0)) return;   // identity: the state stays as it is
  __syncthreads();

  // ---- phase 2: every coefficient, before any element is written
  for (int o = warp; o < 3 * b + 1; o += kWarps) {
    T acc = T(0);
    if (o < b) {                       // dv[o] = sum_s D[o, s] v[s]
      const int r = o;
      for (int s = lane; s < b; s += 32) {
        const T d = (s <= r) ? at(p + r, p + s) : at(p + s, p + r);
        acc += d * v[s];
      }
      acc = warp_sum(acc);
      if (lane == 0) dv[r] = acc;
    } else if (o < 2 * b + 1) {        // cl[s] = sum_r v[r] L[r, s]
      const int s = o - b;
      for (int r = lane; r < b; r += 32)
        acc += v[r] * at(p + r, p - b - 1 + s);
      acc = warp_sum(acc);
      if (lane == 0) cl[s] = acc;
    } else {                           // cr[r] = sum_s F[r, s] v[s]
      const int r = o - (2 * b + 1);
      for (int s = lane; s < b; s += 32)
        acc += at(p + b + r, p + s) * v[s];
      acc = warp_sum(acc);
      if (lane == 0) cr[r] = acc;
    }
  }
  __syncthreads();
  T pv = T(0);
  for (int r = tid; r < b; r += kThreads) pv += v[r] * dv[r];
  const T vdv = block_sum(pv, red);
  const T tt_vdv = th * th * vdv;

  // ---- phase 3: the two-sided update
  for (int idx = tid; idx < b * b; idx += kThreads) {
    const int r = idx / b, s = idx - (idx / b) * b;
    if (s <= r) {                      // D, lower half
      T& d = at(p + r, p + s);
      d = d - th * (v[r] * dv[s]) - th * (dv[r] * v[s])
          + tt_vdv * (v[r] * v[s]);
    }
    T& f = at(p + b + r, p + s);       // fill rows
    f = f - th * (cr[r] * v[s]);
  }
  for (int idx = tid; idx < b * (b + 1); idx += kThreads) {
    const int r = idx / (b + 1), s = idx - (idx / (b + 1)) * (b + 1);
    T& l = at(p + r, p - b - 1 + s);   // left strip
    l = l - th * (v[r] * cl[s]);
  }
}

template <typename T>
int launch(void* lb, void* hv, void* ht, int n, int b, int nt,
           int* launched, void* stream) {
  const int n_lanes = (nt + 3) / 4 + 1;
  const int tau_max = 4 * (n - 3) + nt;
  const size_t smem = static_cast<size_t>(4 * b + 1 + kWarps + 2) * sizeof(T);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(chase_step_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int count = 0;
  for (int tau = 0; tau < tau_max; ++tau) {
    // lanes with 0 <= c <= n-3 and t <= nt-1; liveness is rechecked inside
    int j0 = tau / 4 - (n - 3);
    if (j0 < 0) j0 = 0;
    int j1 = tau / 4;
    const int jt = (nt - 1 - tau % 4);
    if (jt < 0) continue;
    if (jt / 4 < j1) j1 = jt / 4;
    if (n_lanes - 1 < j1) j1 = n_lanes - 1;
    if (j1 < j0) continue;
    chase_step_kernel<T><<<j1 - j0 + 1, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<T*>(lb), static_cast<T*>(hv), static_cast<T*>(ht), n, b,
        nt, tau, j0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++count;
  }
  *launched = count;
  return 0;
}

}  // namespace

// lb (n + 2b, 2b + 1) lower band state, updated in place; hv (n, nt, b) and
// ht (n, nt) zero-filled reflector stores, written at every live (c, t).
// Runs every wavefront step; *launched gets the number of kernel launches.
// Returns the first CUDA error of a launch, else 0.
extern "C" int ek_band_chase_f64(void* lb, void* hv, void* ht, int n, int b,
                                 int nt, int* launched, void* stream) {
  return launch<double>(lb, hv, ht, n, b, nt, launched, stream);
}

extern "C" int ek_band_chase_f32(void* lb, void* hv, void* ht, int n, int b,
                                 int nt, int* launched, void* stream) {
  return launch<float>(lb, hv, ht, n, b, nt, launched, stream);
}
