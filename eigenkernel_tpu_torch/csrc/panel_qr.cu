// Householder QR of one panel of the full-to-band reduction, with its
// compact-WY T factor, as one persistent cooperative launch (kernel D3).
//
// Replaces no TPU kernel: the JAX function (eigenkernel_tpu/ops/band.py::
// _qr_panel) is a lax.scan over the panel's columns that XLA runs, and the
// port's plain version (ops/band.py::_qr_panel followed by
// householder.wy_t_factor) launches some 34 small kernels a column from
// the host.  At n = 22,500 that is ~765,000 launches a solve for ~1.3 s of
// device work, so the host bound the whole stage.
//
// Computes, from the (m, b) panel P (row stride ld, not modified):
//   V (m, b): column j's reflector, unit pivot (or 0) at row j, zero above;
//   taus (b): H_j = I - tau_j v_j v_j^T, so that H_0 ... H_{b-1} P = R;
//   T (b, b): upper triangular, H_0 ... H_{b-1} = I - V T V^T, formed as
//             inv(diag(1/tau) + striu(V^T V)) with tau = 0 read as 1.
// Column j (j < min(m, b)) takes _householder's conventions:
//   sigma = ||P[j+1:, j]||^2, alpha = P[j, j],
//   beta = -sign(alpha) sqrt(alpha^2 + sigma)  (sign(0) = +1),
//   v = [1; P[j+1:, j] / (alpha - beta)], tau = (beta - alpha) / beta,
//   and a zero tail (sigma == 0) gives v = 0, tau = 0: the identity;
// then P[j+1:, j+1:] -= tau v (v^T P[j:, j+1:]).  Columns j >= m (the
// ragged last panel, m < b) are zero with tau = 0.
//
// What bounds it on the card: the chain of b dependent columns, each
// needing sums over all m rows (the column's norm, then v^T P) before the
// next can start.  The bytes (the panel in once and V out once: 23 MB at
// m = 22,436, b = 64, f64, ~7 us at the memory rate) and the flops (~4 m b^2)
// are far below that; the floor is (b + 1) grid barriers (a few us each)
// plus the cross-CTA sums.
//
// What the design does about it:
// * one launch a panel; the grid (ops/band.py::panel_plan) is ceil(m /
//   128) CTAs, at most one per SM, each holding `rows` consecutive rows of
//   the panel in shared memory for the whole factorization (pitch b + 1:
//   row and column walks free of bank conflicts).  P is read from HBM
//   once and V written once; nothing else of size m touches memory;
// * one grid barrier a column.  The column's sums are folded so that one
//   cross-CTA reduction serves it: each CTA publishes, for the next column
//   x, sigma's partial sum_i x_i^2 and s_k = sum_i x_i P[i, k] (k > j),
//   with x not yet scaled; after the barrier every CTA forms
//   w_k = v^T P[j:, k] = head * P[j, k] + s_k / (alpha - beta) itself, so
//   the norm and v^T P need no second barrier.  The row holding the next
//   pivot is published whole by the CTA that owns it;
// * the update of column j+1 (the next pivot column) runs first, so that
//   the same pass over the rows that applies H_j to the other columns also
//   forms the next column's partial sums;
// * the Gram matrix V^T V rides in the same reduction: while the threads
//   of columns k > j+1 update, those of columns l < j form v_l . v_j, into
//   the same partial row; CTA 0 keeps V^T V's columns in T's output and,
//   after the last barrier, forms T by back substitution (dtrsm's order)
//   in shared memory.  No library call, no host synchronization;
// * partial sums are double-buffered by the column's parity, so a CTA may
//   run ahead into the next column while another still reads this one's.
// Sums run in a fixed order, so a launch of a given grid is deterministic;
// against the plain version the sums are grouped differently, and the
// results agree to rounding, not bit for bit.
//
// Every thread reaches every __syncthreads and grid barrier: the loops
// that hold them depend on (m, b) and the column index alone.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 64;                   // column slots of a row group
constexpr int kGroups = kThreads / kLanes;   // row groups
constexpr int kSmemMax = 232448;             // a block's shared memory, sm_90

// Words of shared memory: the panel's rows (pitch b + 1), which CTA 0
// reuses for T's back substitution (b rows of b + 1 words and b pivots),
// the row groups' partial sums (kGroups x (b + 1)), one word a warp, and
// w (b).  ops/band.py::panel_smem_bytes must agree.
__host__ __device__ constexpr long smem_words(int rows, int b) {
  const long slice = static_cast<long>(rows) * (b + 1);
  const long tri = static_cast<long>(b) * (b + 1) + b;
  return (slice > tri ? slice : tri) + static_cast<long>(kGroups) * (b + 1) +
         kWarps + b;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ double root(double x) { return sqrt(x); }
__device__ __forceinline__ float root(float x) { return sqrtf(x); }

// Grid-wide barrier (as csrc/band_chase.cu): *bar counts every arrival of
// the launch and never resets, so barrier number i is passed when it
// reaches i * gridDim.x (compared modulo 2^32).
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& target) {
  target += gridDim.x;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    const volatile unsigned* count = bar;
    while (static_cast<int>(*count - target) < 0) {
    }
    __threadfence();
  }
  __syncthreads();
}

// The first local row >= lo - r0 (and >= 0) of row group g.
__device__ __forceinline__ int first_row(int lo, int r0, int g) {
  const int base = lo > r0 ? lo - r0 : 0;
  return base + ((g - base) % kGroups + kGroups) % kGroups;
}

// part: 2 x grid x (b + 1) partial sums, then 2 x b pivot rows, both by
// column parity; bar: a zeroed word.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
panel_qr_kernel(const T* __restrict__ in, int ld, int m, int b, int rows,
                T* __restrict__ v_out, T* __restrict__ tau_out,
                T* __restrict__ t_out, T* part, unsigned* bar) {
  extern __shared__ unsigned char smem_raw[];
  const int W = b + 1;                       // pitch, and a partial row
  const int grid = gridDim.x, cta = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kc = tid % kLanes, g = tid / kLanes;
  const int r0 = cta * rows;
  const int nr = max(0, min(rows, m - r0));  // this CTA's rows
  const int jmax = min(b, m);
  T* P = reinterpret_cast<T*>(smem_raw);
  const long tri = static_cast<long>(b) * W + b;
  T* red = P + (static_cast<long>(rows) * W > tri ? static_cast<long>(rows) * W
                                                  : tri);
  T* wsum = red + kGroups * W;
  T* wv = wsum + kWarps;
  T* pivot_rows = part + 2L * grid * W;
  unsigned target = 0;

  for (int e = tid; e < nr * b; e += kThreads) {
    const int li = e / b, k = e - li * b;
    P[li * W + k] = in[static_cast<size_t>(r0 + li) * ld + k];
  }
  __syncthreads();

  // Step j applies H_j (none for j = -1) and publishes the sums of column
  // j + 1 and the Gram column j; the barrier closes it.
  for (int j = -1; j < jmax; ++j) {
    const int nx = j + 1;
    const bool next = nx < jmax;
    T tau = 0, head = 0, denom = 1, wnext = 0;
    if (j >= 0) {
      const T* pin = part + static_cast<size_t>(j & 1) * grid * W;
      const T* rin = pivot_rows + static_cast<size_t>(j & 1) * b;
      for (int w = kc; w < W; w += kLanes) {
        const int k = w - 1;
        T acc = 0;
        if (w == 0 || k > j || (cta == 0 && k < j - 1))
          for (int c = g; c < grid; c += kGroups)
            acc += __ldcg(pin + static_cast<size_t>(c) * W + w);
        red[g * W + w] = acc;
      }
      __syncthreads();
      T sigma = 0;
      for (int q = 0; q < kGroups; ++q) sigma += red[q * W];
      const T alpha = __ldcg(rin + j);
      const bool zero_tail = sigma == T(0);
      const T sgn = alpha >= T(0) ? T(1) : T(-1);
      const T mu = root(alpha * alpha + sigma);
      const T beta = zero_tail ? alpha : -sgn * mu;
      denom = zero_tail ? T(1) : alpha - beta;
      tau = zero_tail ? T(0) : (beta - alpha) / (beta == T(0) ? T(1) : beta);
      head = zero_tail ? T(0) : T(1);
      if (next) {
        T s = 0;
        for (int q = 0; q < kGroups; ++q) s += red[q * W + 1 + nx];
        wnext = head * __ldcg(rin + nx) + s / denom;
      }
      if (g == 0) {
        for (int k = kc; k < b; k += kLanes) {
          T s = 0;
          if (k > nx) {
            for (int q = 0; q < kGroups; ++q) s += red[q * W + 1 + k];
            wv[k] = head * __ldcg(rin + k) + s / denom;
          } else if (cta == 0 && k < j - 1) {   // V^T V[k, j - 1]
            for (int q = 0; q < kGroups; ++q) s += red[q * W + 1 + k];
            t_out[static_cast<size_t>(k) * b + j - 1] = s;
          }
        }
      }
      if (cta == 0 && tid == 0) tau_out[j] = tau;
    }

    // Phase A: column j becomes v; column nx takes H_j and its norm.
    T* rout = pivot_rows + static_cast<size_t>(nx & 1) * b;
    T sig = 0;
    for (int li = tid; li < nr; li += kThreads) {
      const int i = r0 + li;
      if (i < (j > 0 ? j : 0)) continue;
      T v = 0;
      if (j >= 0) {
        v = i == j ? head : P[li * W + j] / denom;
        P[li * W + j] = v;
      }
      if (next && i >= nx) {
        T c = P[li * W + nx];
        if (j >= 0) c -= tau * (v * wnext);
        P[li * W + nx] = c;
        if (i == nx) rout[nx] = c;
        else sig += c * c;
      }
    }
    sig = warp_sum(sig);
    if (lane == 0) wsum[warp] = sig;
    __syncthreads();

    // Phase B: columns k > nx take H_j and their sums with column nx;
    // columns l < j their Gram entry with v_j.
    for (int k = kc; k < b; k += kLanes) {
      T acc = 0;
      if (next && k > nx) {
        const T wk = j >= 0 ? wv[k] : T(0);
        for (int li = first_row(nx, r0, g); li < nr; li += kGroups) {
          T p = P[li * W + k];
          if (j >= 0) {
            p -= tau * (P[li * W + j] * wk);
            P[li * W + k] = p;
          }
          if (r0 + li == nx) rout[k] = p;
          else acc += P[li * W + nx] * p;
        }
      } else if (k < j) {
        for (int li = first_row(j, r0, g); li < nr; li += kGroups)
          acc += P[li * W + k] * P[li * W + j];
      }
      red[g * W + 1 + k] = acc;
    }
    __syncthreads();

    T* pout = part + static_cast<size_t>(nx & 1) * grid * W +
              static_cast<size_t>(cta) * W;
    if (g == 0) {
      for (int w = 1 + kc; w < W; w += kLanes) {
        T s = 0;
        for (int q = 0; q < kGroups; ++q) s += red[q * W + w];
        __stcg(pout + w, s);
      }
    }
    if (tid == 0) {
      T s = 0;
      for (int q = 0; q < kWarps; ++q) s += wsum[q];
      __stcg(pout, s);
    }
    grid_sync(bar, target);
  }

  for (int e = tid; e < nr * b; e += kThreads) {
    const int li = e / b, k = e - li * b;
    const int i = r0 + li;
    v_out[static_cast<size_t>(i) * b + k] =
        k < jmax && i >= k ? P[li * W + k] : T(0);
  }
  if (cta != 0) return;

  // CTA 0: T = inv(M), M = diag(1/tau) + striu(V^T V), M upper.  X (rows
  // of b + 1 words) holds the solution on and above the diagonal and M's
  // strict upper part transposed below it; dg holds M's diagonal.
  __syncthreads();
  T* X = P;
  T* dg = P + static_cast<long>(b) * W;
  const T* pin = part + static_cast<size_t>(jmax & 1) * grid * W;
  for (int e = tid; e < b * b; e += kThreads) {
    const int r = e / b, t = e - r * b;
    if (r < t) {
      T gm = 0;
      if (t < jmax - 1) {
        gm = t_out[e];
      } else if (t == jmax - 1) {              // the last column's sums
        for (int c = 0; c < grid; ++c)
          gm += __ldcg(pin + static_cast<size_t>(c) * W + 1 + r);
      }
      X[r * W + t] = 0;
      X[t * W + r] = gm;
    } else if (r == t) {
      X[r * W + r] = 1;
    }
  }
  for (int t = tid; t < b; t += kThreads) {
    const T ta = t < jmax ? tau_out[t] : T(0);
    if (t >= jmax) tau_out[t] = 0;
    dg[t] = T(1) / (ta == T(0) ? T(1) : ta);
  }
  __syncthreads();
  for (int i = b - 1; i >= 0; --i) {
    for (int t = i + tid; t < b; t += kThreads) X[i * W + t] /= dg[i];
    __syncthreads();
    const int cols = b - i;
    for (int e = tid; e < i * cols; e += kThreads) {
      const int r = e / cols, t = i + e - r * cols;
      X[r * W + t] -= X[i * W + t] * X[i * W + r];
    }
    __syncthreads();
  }
  for (int e = tid; e < b * b; e += kThreads) {
    const int r = e / b, t = e - r * b;
    t_out[e] = r <= t ? X[r * W + t] : T(0);
  }
}

template <typename T>
int launch(const void* in, int ld, int m, int b, int rows, int grid, void* v,
           void* tau, void* t, void* part, void* bar, void* stream) {
  if (m < 1 || b < 1 || ld < b || rows < 1 || grid < 1 ||
      static_cast<long>(rows) * grid < m)
    return cudaErrorInvalidValue;
  const long smem = smem_words(rows, b) * static_cast<long>(sizeof(T));
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  const void* kernel = reinterpret_cast<const void*>(panel_qr_kernel<T>);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&in, &ld, &m, &b, &rows, &v, &tau, &t, &part, &bar};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      kernel, dim3(grid), dim3(kThreads), args, static_cast<size_t>(smem),
      static_cast<cudaStream_t>(stream)));
}

}  // namespace

// Bytes of shared memory a CTA of `rows` rows takes at panel width b and
// itemsize isz (ops/band.py::panel_smem_bytes).
extern "C" int ek_panel_qr_smem(int rows, int b, int isz) {
  return static_cast<int>(smem_words(rows, b) * isz);
}

// in: the (m, b) panel, row stride ld (not modified); v (m, b), tau (b),
// t (b, b) outputs, every entry written; part: 2 grid (b + 1) + 2 b
// scratch words; bar: a zeroed unsigned word.  One cooperative launch of
// `grid` CTAs of `rows` rows each (rows * grid >= m).  Returns the CUDA
// error of the launch, else 0.
extern "C" int ek_panel_qr_f64(const void* in, int ld, int m, int b, int rows,
                               int grid, void* v, void* tau, void* t,
                               void* part, void* bar, void* stream) {
  return launch<double>(in, ld, m, b, rows, grid, v, tau, t, part, bar,
                        stream);
}

extern "C" int ek_panel_qr_f32(const void* in, int ld, int m, int b, int rows,
                               int grid, void* v, void* tau, void* t,
                               void* part, void* bar, void* stream) {
  return launch<float>(in, ld, m, b, rows, grid, v, tau, t, part, bar,
                       stream);
}
