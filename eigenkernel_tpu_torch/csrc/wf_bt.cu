// Stage-2 (bulge-chase) eigenvector back-transform z <- Q2 z on the
// composite group wavefront: at composite step u, every live group lane G
// applies one explicit (S2 x S2) transform P[u, G] to its S2-row window of
// z, S2 = g + m b.  P (built in PyTorch, ops/wf_bt.py::_q_stream) is the
// product of m consecutive band positions of the WY-grouped reflectors of
// g consecutive sweeps.
//
// Replaces: eigenkernel_tpu/ops/pallas_wf_bt.py::
// apply_chase_q_wavefront_pallas (Pallas kernel _wf_bt_kernel), which pins
// a column tile of the whole z frame in VMEM across all steps and needs
// 8 | b, 8 | g, b + g <= 128 and S2 <= 256 for Mosaic.  Here any b, g,
// m >= 1 run.
//
// One launch per composite step u with live lanes; one CTA per (live lane
// G, tile of kTileCols columns of z).  The window of lane G starts at frame
// row row0 = (n - 1 - g) - G S2 + m b u + top; windows of one u are
// S2 rows apart, so they are disjoint and the CTAs of a launch never touch
// the same element.  A CTA reads its whole S2 x kTileCols window into
// shared memory, then writes P[u, G] @ window back in place: kRows output
// rows at a time, each thread holding kRows / 8 rows of one column in
// registers, with P staged through shared memory kDepth columns at a time.
//
// Live lanes (the host loop below, as pallas_wf_bt.py bounds its lane
// loop): G <= u, u - G < Tm, and the window starts above the end of z,
// G >= floor((m b u + K - n) / S2) + 1 with K = n - 1 - g.  Every other
// (u, G) slot of the P stream holds garbage and is never read.
//
// What bounds it on the card: arithmetic, 2 S2^2 flops per element of z
// per live lane, on CUDA cores (FP64 FMA in float64).  The z window is read
// and written once per lane; P is read once per column tile.  What the
// design does about it: register blocking over rows and a shared z window
// reused for all S2 output rows.  Tensor cores (DMMA / wgmma) and a
// persistent z tile across steps, as the Pallas kernel keeps in VMEM, are
// later work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTileCols = 32;            // z columns per CTA (one warp wide)
constexpr int kRowThreads = 8;           // warps; output row stride
constexpr int kRowsPerThread = 16;
constexpr int kRows = kRowThreads * kRowsPerThread;   // output rows per pass
constexpr int kDepth = 16;               // P columns staged per step
constexpr int kThreads = kTileCols * kRowThreads;

template <typename T>
__global__ void wf_bt_kernel(const T* __restrict__ p_u, T* __restrict__ zp,
                             int k, int s2, int row_base, int g_lo) {
  extern __shared__ unsigned char smem_raw[];
  T* zs = reinterpret_cast<T*>(smem_raw);          // (s2, kTileCols)
  T* ps = zs + static_cast<size_t>(s2) * kTileCols;  // (kRows, kDepth)

  const int lane_g = g_lo + blockIdx.x;
  const int row0 = row_base - lane_g * s2;
  const int col0 = blockIdx.y * kTileCols;
  const int tx = threadIdx.x % kTileCols, ty = threadIdx.x / kTileCols;
  const size_t ldz = static_cast<size_t>(k);
  const T* p = p_u + static_cast<size_t>(lane_g) * s2 * s2;

  for (int idx = threadIdx.x; idx < s2 * kTileCols; idx += kThreads) {
    const int l = idx / kTileCols, cc = idx % kTileCols;
    const int col = col0 + cc;
    zs[idx] = col < k ? zp[(row0 + l) * ldz + col] : T(0);
  }
  __syncthreads();

  const int col = col0 + tx;
  for (int i0 = 0; i0 < s2; i0 += kRows) {
    T acc[kRowsPerThread];
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) acc[q] = T(0);
    for (int l0 = 0; l0 < s2; l0 += kDepth) {
      for (int idx = threadIdx.x; idx < kRows * kDepth; idx += kThreads) {
        const int ii = idx / kDepth, ll = idx % kDepth;
        const int i = i0 + ii, l = l0 + ll;
        ps[idx] = (i < s2 && l < s2) ? p[static_cast<size_t>(i) * s2 + l]
                                     : T(0);
      }
      __syncthreads();
      const int depth = s2 - l0 < kDepth ? s2 - l0 : kDepth;
      for (int ll = 0; ll < depth; ++ll) {
        const T zv = zs[(l0 + ll) * kTileCols + tx];
#pragma unroll
        for (int q = 0; q < kRowsPerThread; ++q)
          acc[q] += ps[(ty + kRowThreads * q) * kDepth + ll] * zv;
      }
      __syncthreads();
    }
    if (col < k) {
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) {
        const int i = i0 + ty + kRowThreads * q;
        if (i < s2) zp[(row0 + i) * ldz + col] = acc[q];
      }
    }
  }
}

int floor_div(int a, int b) {             // b > 0
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

template <typename T>
int launch(const void* p, void* zp, int k, int n, int b, int g, int m,
           int n_groups, int tm, int top, int u0, int tc, int* launched,
           void* stream) {
  const int s2 = g + m * b;
  const int kk = n - 1 - g;                 // nsweeps + 1 - g
  const size_t smem =
      (static_cast<size_t>(s2) * kTileCols + kRows * kDepth) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      wf_bt_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int col_tiles = (k + kTileCols - 1) / kTileCols;
  int count = 0;
  for (int uu = 0; uu < tc; ++uu) {
    const int u = u0 + uu;
    int g_lo = u - (tm - 1);
    if (g_lo < 0) g_lo = 0;
    const int g_tail = floor_div(m * b * u + kk - n, s2) + 1;
    if (g_tail > g_lo) g_lo = g_tail;
    const int g_hi = (n_groups - 1 < u) ? n_groups - 1 : u;
    if (g_lo > g_hi) continue;
    const T* p_u = static_cast<const T*>(p) +
                   static_cast<size_t>(uu) * n_groups * s2 * s2;
    const int row_base = kk + m * b * u + top;
    wf_bt_kernel<T><<<dim3(g_hi - g_lo + 1, col_tiles), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        p_u, static_cast<T*>(zp), k, s2, row_base, g_lo);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++count;
  }
  *launched = count;
  return 0;
}

}  // namespace

// p: the (tc, n_groups, s2, s2) transforms of composite steps
// [u0, u0 + tc); zp: the (rows, k) row-major z frame (z at rows
// [top, top + n)), updated in place.  *launched gets the number of kernel
// launches.  Returns the first CUDA error, else 0.
extern "C" int ek_wf_bt_f64(const void* p, void* zp, int k, int n, int b,
                            int g, int m, int n_groups, int tm, int top,
                            int u0, int tc, int* launched, void* stream) {
  return launch<double>(p, zp, k, n, b, g, m, n_groups, tm, top, u0, tc,
                        launched, stream);
}

extern "C" int ek_wf_bt_f32(const void* p, void* zp, int k, int n, int b,
                            int g, int m, int n_groups, int tm, int top,
                            int u0, int tc, int* launched, void* stream) {
  return launch<float>(p, zp, k, n, b, g, m, n_groups, tm, top, u0, tc,
                       launched, stream);
}
