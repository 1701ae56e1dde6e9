// Stage-2 (bulge-chase) eigenvector back-transform z <- Q2 z, one sweep at
// a time: sweep c holds T disjoint reflectors H = I - tau v v^T, window t
// on rows [c + 1 + t b, c + 1 + (t + 1) b), and Q2 z applies the sweeps
// newest first (c = n-3 down to 0).
//
// Replaces: eigenkernel_tpu/ops/pallas_backtransform.py::
// apply_chase_q_pallas (Pallas kernel _backtransform_kernel), which pins a
// column tile of z in VMEM and streams the reflectors over it, pre-shifted
// to 8-row alignment and scaled by sqrt(tau).  Neither trick carries over:
// the card has no sublane alignment rule, and H is applied as it is.
//
// Columns of z are independent, so one CTA owns kCols columns and walks
// all n - 2 sweeps in reverse, with __syncthreads between sweeps (the
// windows of sweep c - 1 are those of sweep c shifted up one row).  Inside
// a sweep each warp takes windows t = warp, warp + 8, ...; its 32 lanes are
// kCols columns x 4 row groups, so every row access reads kCols
// neighbouring words and the window's dot product v . z[:, col] closes with
// two shuffles.  Windows whose tau is 0 (past the end of a short sweep) are
// skipped.
//
// What bounds it on the card: memory.  Every sweep reads and writes the
// CTA's whole column slab of z, 2 n k itemsize bytes per sweep and about
// 2 n^2 k itemsize bytes in all, served from L2 while the slabs of the
// resident CTAs fit there (50 MB).  What the design does about it:
// nothing yet beyond coalesced rows and skipped empty windows; grouping
// sweeps into WY blocks (the wf_bt.cu kernel) is the way to cut the
// traffic.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;                  // z columns per CTA
constexpr int kGroups = 32 / kCols;       // row groups per warp

template <typename T>
__global__ void chase_bt_kernel(const T* __restrict__ hv,
                                const T* __restrict__ ht, T* __restrict__ z,
                                int n, int k, int nt, int b) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * kCols + (lane % kCols);
  const int rg = lane / kCols;
  const bool has_col = col < k;
  const size_t ldz = static_cast<size_t>(k);
  for (int c = n - 3; c >= 0; --c) {
    for (int t = warp; t < nt; t += kWarps) {
      const int row0 = c + 1 + t * b;
      if (row0 >= n) break;
      const T tau = ht[static_cast<size_t>(c) * nt + t];
      if (tau == T(0)) continue;
      const T* v = hv + (static_cast<size_t>(c) * nt + t) * b;
      T part = T(0);
      for (int r = rg; r < b && row0 + r < n; r += kGroups)
        if (has_col) part += v[r] * z[(row0 + r) * ldz + col];
      for (int o = kCols; o < 32; o <<= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      const T coef = part * tau;
      if (has_col)
        for (int r = rg; r < b && row0 + r < n; r += kGroups)
          z[(row0 + r) * ldz + col] -= v[r] * coef;
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* hv, const void* ht, void* z, int n, int k, int nt,
           int b, void* stream) {
  const int blocks = (k + kCols - 1) / kCols;
  chase_bt_kernel<T><<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(hv), static_cast<const T*>(ht),
      static_cast<T*>(z), n, k, nt, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hv (n, nt, b), ht (n, nt) chase reflectors; z (n, k) row-major, updated
// in place.  Returns cudaGetLastError() after the launch.
extern "C" int ek_chase_bt_f64(const void* hv, const void* ht, void* z,
                               int n, int k, int nt, int b, void* stream) {
  return launch<double>(hv, ht, z, n, k, nt, b, stream);
}

extern "C" int ek_chase_bt_f32(const void* hv, const void* ht, void* z,
                               int n, int k, int nt, int b, void* stream) {
  return launch<float>(hv, ht, z, n, k, nt, b, stream);
}
