// One panel of the one-stage Householder tridiagonalization (LAPACK's
// dlatrd, lower), as one persistent cooperative launch (kernel D4).
//
// Replaces no Pallas kernel: the JAX function's panel is the fori_loop of
// eigenkernel_tpu/ops/householder.py::_panel_body, which XLA runs, and the
// port's plain version (ops/householder.py::tridiag_panel_plain) launches
// some 50 small kernels a column from the host.  At n = 22,500 that is
// ~1.1 million launches a solve, and the host, not the card, bound the
// stage (58 % of the card idle).
//
// Computes, from the trailing block A = As (m, m, row stride ld, symmetric;
// only its lower triangle is read, and nothing of it is written) and the
// panel width bw (<= m), what tridiag_panel_plain computes:
//   for column j = 0 .. bw-1 (r = j + 1, the pivot row):
//     col = A[j:, j] - V[j:, :j] W[j, :j]^T - W[j:, :j] V[j, :j]^T,
//     d[j] = col[0]; the column j = m - 1 closes the matrix: d only;
//     alpha = col[1], sigma = ||col[2:]||^2,
//     beta = -sign(alpha) sqrt(alpha^2 + sigma) (sign(0) = +1),
//     v = [1; col[2:] / (alpha - beta)], tau = (beta - alpha) / beta, and
//     a zero tail (sigma == 0) gives head 0, tau 0: the identity;
//     e[j] = beta, tau[j] = tau,
//     w' = tau (A[r:, r:] v - V (W^T v) - W (V^T v)),
//     w = w' - (tau / 2) (w'^T v) v;
//     V[r:, j] = v, W[r:, j] = w (both zero above row r).
// The tail is scaled by the reciprocal of alpha - beta, as dlarfg does.
//
// What bounds it on the card: each column's A[r:, r:] v reads the lower
// triangle of the trailing square, (m - r)^2 / 2 words, so a panel reads
// ~bw m^2 / 2 words: 4.53 s a solve at n = 22,500 float64 against the
// 3.35 TB/s of HBM3 (the whole square, as a general GEMV reads it, would
// be 9.07 s).  Beside it, a chain of 3 grid barriers a column with the
// cross-CTA sums between them.  The V, W work is ~6 m j words a column.
//
// What the design does about it:
// * one launch a panel, one CTA an SM (ops/householder.py::trd_plan: all
//   SMs while the panel has at least 4 units a CTA), 3 grid barriers a
//   column: after col's sums, after A v's partial sums, after w';
// * A v reads only the lower triangle, cut into strips of w columns (w =
//   256 in float64, 512 in float32) and each strip into units of 16 rows
//   from the first the diagonal crosses down; the units, numbered strip by
//   strip, are cut into one contiguous range a CTA, the same for every
//   column of the panel.  A unit gives A_US v_S to y_U and A_US^T v_U to
//   y_S.  A warp reads one row of a unit, w contiguous words (2 KB; lane l
//   copies the 16-byte chunks l, l + 32, l + 64 and l + 96, so that each
//   copy instruction of a warp covers 512 contiguous bytes and each read
//   back from shared memory is free of bank conflicts), so that A_US v_S
//   is a warp's sum, formed for 4 units at once by one transposing
//   butterfly.  The loop is bound by its instructions more than by the
//   bytes (copies alone stream at 96 % of HBM3), so the common copy takes
//   a short path.  The units pass through a ring of 4 in shared memory
//   (cp.async: 3 units, 96 KB an SM, in flight while it works on one, and
//   no registers held for them); each thread copies and reads back only
//   its own chunks, so the ring needs no block barrier.  A_US^T v_U stays
//   in registers down the CTA's run of units in strip S and is summed
//   over the warps once, at the run's end;
// * no floating-point atomics: the row sums go to a slot a unit, the
//   column sums to a slot a run (strip S, CTA c: slot S + c, distinct
//   because the ranges are contiguous and in order), and the owner of a
//   row adds its slots in a fixed order.  Every sum across CTAs runs in a
//   fixed order, so a launch of a given grid is deterministic; against the
//   plain version the sums are grouped differently, and the results agree
//   to rounding, not bit for bit;
// * every CTA forms the reflector's scalars itself from the published
//   partial sums, and each element of v from col (v_i = col_i / (alpha -
//   beta)) where a unit needs it, so v needs no barrier of its own;
// * the last axpy of w (its w'^T v) is folded into the next column's first
//   phase, and the next column's pending update from columns < j is formed
//   in the same pass over a row's V and W as w's correction, so that a
//   column reads V and W twice; every CTA forms the scalars it needs of
//   row j + 1 itself; the CTAs' partial sums are read a run of columns a
//   warp, and the loops keep many loads in flight, so that a column's
//   chain is a few round trips, not j of them;
// * V and W are kept transposed (a row of m words a column: the row
//   phases read them coalesced) in a (3 bw, m) output [V^T; W^T; V^T],
//   whose first and last 2 bw rows are the rank-2b update's [V W] and
//   [W V].
// Scratch: 16 words a unit and w a run, the column, w', y (m each) and the
// CTAs' partial sums: 9.1 MB at m = 22,500, bw = 64, float64.
//
// Every thread reaches every __syncthreads and grid barrier: the loops
// that hold them depend on (m, bw, grid), the column and the CTA alone.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kHigh = kWarps;               // rows of a unit: one a warp
constexpr int kChunk = 64;                  // rows a pass of phase 3 sums
constexpr int kSlices = kThreads / kChunk;  // slices of a row's unit sums
constexpr int kMaxB = 256;                  // widest panel

constexpr int kStages = 4;                  // units in the ring: 3 in flight
static_assert((kStages & (kStages - 1)) == 0, "the ring's index is a mask");
constexpr int kChunks = 4;                  // 16-byte chunks a lane a unit
constexpr int kGroup = 8;                   // columns a warp sums at once

// Words of a 16-byte chunk, a thread's words of a unit (lane l holds
// chunks l, l + 32, l + 64 and l + 96 of its warp's row), a strip's width
// (a warp's row of a unit, 2 KB) and the strip's width in units' heights.
template <typename T>
constexpr int kVec = 16 / sizeof(T);
template <typename T>
constexpr int kSeg = kChunks * kVec<T>;
template <typename T>
constexpr int kWide = 32 * kSeg<T>;
template <typename T>
constexpr int kRatio = kWide<T> / kHigh;

// Dynamic shared memory: the ring of units.
template <typename T>
constexpr int kRingBytes = kStages * kHigh * kWide<T> * sizeof(T);

template <typename T>
struct Vec16;
template <>
struct Vec16<double> {
  using type = double2;
};
template <>
struct Vec16<float> {
  using type = float4;
};

__device__ __forceinline__ double root(double x) { return sqrt(x); }
__device__ __forceinline__ float root(float x) { return sqrtf(x); }

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Grid-wide barrier (as csrc/panel_qr.cu): *bar counts every arrival of
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

// The lower triangle in units: strip S (columns [S w, S w + w), w =
// kWide) holds the units of rows [U h, U h + h), h = kHigh, for U from
// kRatio S (the first unit the diagonal crosses) to nu - 1; units are
// numbered strip by strip.  The number of strip S's first unit:
template <typename T>
__host__ __device__ __forceinline__ long long strip_start(int S, int nu) {
  return static_cast<long long>(S) * nu -
         static_cast<long long>(kRatio<T>) * S * (S - 1) / 2;
}

// Strips that hold units, and units, of an (m, m) block.
template <typename T>
__host__ __device__ __forceinline__ int strips(int m) {
  const int nu = (m + kHigh - 1) / kHigh;
  return (nu + kRatio<T> - 1) / kRatio<T>;
}

// Words of scratch (ops/householder.py::trd_scratch_words must agree):
// a slot of h words a unit and of w a run, col, w', y, and the partial
// sums of sigma, w'^T v and [V W]^T v.
template <typename T>
__host__ __device__ long long scratch_words(int m, int bw, int grid) {
  const int nu = (m + kHigh - 1) / kHigh, ns = strips<T>(m);
  return kHigh * strip_start<T>(ns, nu) +
         static_cast<long long>(kWide<T>) * (ns + grid) + 3LL * m +
         static_cast<long long>(grid) * (2 + 2 * bw);
}

// The sum of the CTAs' partial sums part[c * stride], c < grid, in a
// fixed order; every lane of the warp gets the same bits.
template <typename T>
__device__ __forceinline__ T sum_parts(const T* part, int stride, int grid,
                                       int lane) {
  T s = 0;
#pragma unroll 4
  for (int c = lane; c < grid; c += 32)
    s += __ldcg(part + static_cast<size_t>(c) * stride);
  return warp_sum(s);
}

// v_i of the column's reflector (0 outside rows r .. m-1).
template <typename T>
__device__ __forceinline__ T v_at(const T* col, int i, int r, int m, T head,
                                  T inv) {
  if (i < r || i >= m) return T(0);
  return i == r ? head : __ldcg(col + i) * inv;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(N), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The column of a thread's word k of a unit of strip S.
template <typename T>
__device__ __forceinline__ int seg_col(int S, int lane, int k) {
  return S * kWide<T> + (lane + 32 * (k / kVec<T>)) * kVec<T> + k % kVec<T>;
}

// Start the copy of a thread's words of row `row` of a unit of strip S
// into dst (the warp's row in the ring; zeros past m and for a chunk
// wholly above the diagonal, which no product reads), as one commit group.
template <typename T>
__device__ __forceinline__ void issue_seg(const T* __restrict__ a, int ld,
                                          int m, int row, int S, int lane,
                                          bool vec, T* dst) {
  constexpr int kV = kVec<T>;
  if (vec && (S + 1) * kWide<T> <= row + 1 && row < m) {
    // the common case: the strip's row wholly at or below the diagonal
    const T* src = a + static_cast<size_t>(row) * ld + S * kWide<T> +
                   lane * kV;
#pragma unroll
    for (int q = 0; q < kChunks; ++q)
      cp_async16(dst + (lane + 32 * q) * kV, src + 32 * q * kV);
    cp_async_commit();
    return;
  }
  const T* base = a + static_cast<size_t>(row < m ? row : 0) * ld;
#pragma unroll
  for (int q = 0; q < kChunks; ++q) {
    const int c = lane + 32 * q, col = S * kWide<T> + c * kV;
    const bool live = row < m && col <= row;
    if (vec) {
      const int n = live ? min(kV, m - col) : 0;
      cp_async16(dst + c * kV, live ? base + col : a, n * sizeof(T));
    } else {
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        const bool on = live && col + e < m;
        cp_async<sizeof(T)>(dst + c * kV + e, on ? base + col + e : a,
                            on ? sizeof(T) : 0);
      }
    }
  }
  cp_async_commit();
}

// vt: (3 bw, m) output; scratch: scratch_words(m, bw, grid) words; bar: a
// zeroed unsigned word.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
panel_trd_kernel(const T* __restrict__ a, int ld, int m, int bw, int vec,
                 T* vt, T* d_out, T* e_out, T* tau_out, T* scratch,
                 unsigned* bar) {
  constexpr int kS = kSeg<T>, kW = kWide<T>, kR = kRatio<T>;
  extern __shared__ __align__(16) unsigned char ring_raw[];
  T* ring = reinterpret_cast<T*>(ring_raw);   // kStages units
  __shared__ T cred[kWarps][kW];         // a run's column sums, by warp
  __shared__ T ys[kSlices][kChunk];      // a row chunk's slice sums
  __shared__ T rowj[2][kMaxB];           // row j + 1 of V and W
  __shared__ T tot[2 * kMaxB];           // V^T v, W^T v
  __shared__ T wsum[kWarps];

  const int grid = gridDim.x, cta = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = (m + grid - 1) / grid;
  const int r0 = min(m, cta * rows), r1 = min(m, r0 + rows);
  const int nu = (m + kHigh - 1) / kHigh, ns = strips<T>(m);
  const long long units = strip_start<T>(ns, nu);
  const long long per = (units + grid - 1) / grid;   // units a CTA
  const long long u_lo = per * cta;
  const long long u_hi = u_lo + per < units ? u_lo + per : units;
  // the strip and row unit of this CTA's first unit
  int s_lo = 0;
  if (u_lo < u_hi) {
    const double b = nu + 0.5 * kR;
    s_lo = static_cast<int>(
        floor((b - sqrt(b * b - 2.0 * kR * static_cast<double>(u_lo))) / kR));
    s_lo = max(0, min(s_lo, ns - 1));
    while (s_lo + 1 < ns && strip_start<T>(s_lo + 1, nu) <= u_lo) ++s_lo;
    while (s_lo > 0 && strip_start<T>(s_lo, nu) > u_lo) --s_lo;
  }
  const int r_lo =
      kR * s_lo + static_cast<int>(u_lo - strip_start<T>(s_lo, nu));

  T* Vt = vt;                                       // V^T, row l: column l
  T* Wt = vt + static_cast<size_t>(bw) * m;         // W^T
  T* Vd = vt + 2 * static_cast<size_t>(bw) * m;     // V^T again
  T* rowpart = scratch;                              // kHigh a unit
  T* colpart = rowpart + kHigh * units;              // kW a run
  T* colbuf = colpart + static_cast<size_t>(kW) * (ns + grid);
  T* wprime = colbuf + m;
  T* ybuf = wprime + m;
  T* part_sig = ybuf + m;
  T* part_dot = part_sig + grid;
  T* part_vw = part_dot + grid;                     // grid x 2 bw

  unsigned target = 0;
  T tau_prev = 0;

  for (int j = 0; j <= bw; ++j) {
    // ---- phase 1: w of column j - 1, then column j: A's column less the
    // pending updates of columns < j - 1, which phase 3 left in colbuf
    // (column 0: A's own), less column j - 1's; its norm's partial sum
    T coef = 0, wj = 0, vj = 0;            // W[j, j - 1], V[j, j - 1]
    if (j > 0) {
      coef = T(0.5) * tau_prev * sum_parts(part_dot, 1, grid, lane);
      vj = __ldcg(Vt + static_cast<size_t>(j - 1) * m + j);
      wj = __ldcg(wprime + j) - coef * vj;
    }
    T sig = 0;
    for (int i = max(j, r0) + tid; i < r1; i += kThreads) {
      T c;
      if (j == 0) {
        c = a[static_cast<size_t>(i) * ld];
      } else {
        const T v = __ldcg(Vt + static_cast<size_t>(j - 1) * m + i);
        const T w = __ldcg(wprime + i) - coef * v;
        __stcg(Wt + static_cast<size_t>(j - 1) * m + i, w);
        if (j == bw) continue;
        c = __ldcg(colbuf + i) - (v * wj + w * vj);
      }
      __stcg(colbuf + i, c);
      if (i == j) d_out[j] = c;
      if (i >= j + 2) sig += c * c;
    }
    if (j == bw) break;
    if (j == m - 1) {                 // the column that closes the matrix
      for (int i = r0 + tid; i < r1; i += kThreads) {
        Vt[static_cast<size_t>(j) * m + i] = T(0);
        Wt[static_cast<size_t>(j) * m + i] = T(0);
        Vd[static_cast<size_t>(j) * m + i] = T(0);
      }
      break;
    }
    sig = warp_sum(sig);
    if (lane == 0) wsum[warp] = sig;
    __syncthreads();
    if (tid == 0) {
      T s = 0;
      for (int q = 0; q < kWarps; ++q) s += wsum[q];
      __stcg(part_sig + cta, s);
    }
    grid_sync(bar, target);

    // ---- phase 2: the reflector, A v over the lower triangle
    const int r = j + 1;
    const T sigma = sum_parts(part_sig, 1, grid, lane);
    const T alpha = __ldcg(colbuf + r);
    const bool zero_tail = sigma == T(0);
    const T sgn = alpha >= T(0) ? T(1) : T(-1);
    const T mu = root(alpha * alpha + sigma);
    const T beta = zero_tail ? alpha : -sgn * mu;
    const T denom = zero_tail ? T(1) : alpha - beta;
    const T tau = zero_tail ? T(0)
                            : (beta - alpha) / (beta == T(0) ? T(1) : beta);
    const T head = zero_tail ? T(0) : T(1);
    const T inv = T(1) / denom;
    tau_prev = tau;
    for (int i = r0 + tid; i < r1; i += kThreads) {
      const T v = v_at(colbuf, i, r, m, head, inv);
      __stcg(Vt + static_cast<size_t>(j) * m + i, v);
      __stcg(Vd + static_cast<size_t>(j) * m + i, v);
    }

    // A v: this CTA's units, strip by strip; a warp a row of a unit, a
    // lane its chunks of it, through a ring of kStages units in shared
    // memory that each thread fills and reads for itself; the ring's first
    // units load while the CTA forms its partial sums of V^T v and W^T v
    int S = s_lo, U = r_lo, Si = s_lo, Ui = r_lo;
    const int n_units = u_hi > u_lo ? static_cast<int>(u_hi - u_lo) : 0;
    auto next = [&](int& uu, int& ss) {
      if (++uu == nu) uu = kR * ++ss;
    };
    T* const ring_w = ring + warp * kW;    // this warp's row of stage 0
    auto slot = [&](int stage) { return ring_w + stage * (kHigh * kW); };
#pragma unroll
    for (int q = 0; q < kStages - 1; ++q) {
      if (q < n_units) {
        issue_seg(a, ld, m, Ui * kHigh + warp, Si, lane, vec != 0,
                  slot(q));
        next(Ui, Si);
      } else {
        cp_async_commit();
      }
    }
    __syncthreads();
    // partial sums of V^T v and W^T v (columns l < j) over this CTA's rows
    // (kGroup columns a warp at once, so that their loads are in flight
    // together)
    for (int w0 = warp * kGroup; w0 < 2 * j; w0 += kWarps * kGroup) {
      T acc[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) acc[g] = T(0);
#pragma unroll 4
      for (int i = max(r, r0) + lane; i < r1; i += 32) {
        const T v = __ldcg(Vt + static_cast<size_t>(j) * m + i);
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const int w = w0 + g;
          if (w < 2 * j)
            acc[g] += __ldcg((w < j ? Vt + static_cast<size_t>(w) * m
                                    : Wt + static_cast<size_t>(w - j) * m) +
                             i) * v;
        }
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const T sum = warp_sum(acc[g]);
        if (lane == 0 && w0 + g < 2 * j)
          __stcg(part_vw + static_cast<size_t>(cta) * 2 * bw + w0 + g, sum);
      }
    }
    if (u_lo < u_hi) {
      T vs[kS], cacc[kS];
#pragma unroll
      for (int k = 0; k < kS; ++k) {
        vs[k] = v_at(colbuf, seg_col<T>(S, lane, k), r, m, head, inv);
        cacc[k] = T(0);
      }
      T vr = v_at(colbuf, U * kHigh + warp, r, m, head, inv);
      T rq0 = 0, rq1 = 0, rq2 = 0, rq3 = 0;   // the last 4 units' row sums
      for (int t = 0; t < n_units; ++t) {
        const int stage = t & (kStages - 1);
        if (t + kStages - 1 < n_units) {
          issue_seg(a, ld, m, Ui * kHigh + warp, Si, lane, vec != 0,
                    slot((t + kStages - 1) & (kStages - 1)));
          next(Ui, Si);
        } else {
          cp_async_commit();
        }
        int Un = U, Sn = S;
        next(Un, Sn);
        const bool more = t + 1 < n_units;
        const T vrn =
            more ? v_at(colbuf, Un * kHigh + warp, r, m, head, inv) : T(0);
        cp_async_wait<kStages - 1>();
        const T* xs = slot(stage);
        T x[kS];
#pragma unroll
        for (int q = 0; q < kChunks; ++q) {
          using V = typename Vec16<T>::type;
          const V w = *reinterpret_cast<const V*>(xs + (lane + 32 * q) *
                                                  kVec<T>);
          const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
          for (int i = 0; i < kVec<T>; ++i) x[q * kVec<T> + i] = e[i];
        }
        const int row = U * kHigh + warp;
        T rs = 0;
        if ((S + 1) * kW <= U * kHigh) {   // wholly below the diagonal
#pragma unroll
          for (int k = 0; k < kS; ++k) {
            rs += x[k] * vs[k];
            cacc[k] += x[k] * vr;
          }
        } else {                           // the diagonal crosses it
#pragma unroll
          for (int k = 0; k < kS; ++k) {
            const int col = seg_col<T>(S, lane, k);
            rs += (col <= row ? x[k] : T(0)) * vs[k];
            cacc[k] += (col < row ? x[k] : T(0)) * vr;
          }
        }
        // the lanes' row sums of 4 units at a time, reduced over the warp
        // together (3 exchanges of a word a unit instead of 5): lanes 8q..
        // 8q+7 end with rq_q, the sum of unit t - 3 + q
        rq0 = rq1;
        rq1 = rq2;
        rq2 = rq3;
        rq3 = rs;
        if ((t & 3) == 3 || !more) {
          const bool h16 = lane & 16, h8 = lane & 8;
          const T b0 = (h16 ? rq2 : rq0) +
                       __shfl_xor_sync(0xffffffffu, h16 ? rq0 : rq2, 16);
          const T b1 = (h16 ? rq3 : rq1) +
                       __shfl_xor_sync(0xffffffffu, h16 ? rq1 : rq3, 16);
          T c = (h8 ? b1 : b0) +
                __shfl_xor_sync(0xffffffffu, h8 ? b0 : b1, 8);
          c += __shfl_xor_sync(0xffffffffu, c, 4);
          c += __shfl_xor_sync(0xffffffffu, c, 2);
          c += __shfl_xor_sync(0xffffffffu, c, 1);
          const int q = lane >> 3;
          if ((lane & 7) == 0 && q >= 3 - (t & 3))
            __stcg(rowpart + (u_lo + t - 3 + q) * kHigh + warp, c);
          rq0 = rq1 = rq2 = rq3 = T(0);
        }
        if (!more || Sn != S) {            // the run in strip S ends
#pragma unroll
          for (int k = 0; k < kS; ++k)
            cred[warp][seg_col<T>(0, lane, k)] = cacc[k];
          __syncthreads();
          for (int c = tid; c < kW; c += kThreads) {
            T sum = 0;
            for (int w = 0; w < kWarps; ++w) sum += cred[w][c];
            __stcg(colpart + static_cast<size_t>(S + cta) * kW + c, sum);
          }
          __syncthreads();
          if (more) {
#pragma unroll
            for (int k = 0; k < kS; ++k) {
              vs[k] = v_at(colbuf, seg_col<T>(Sn, lane, k), r, m, head,
                           inv);
              cacc[k] = T(0);
            }
          }
        }
        vr = vrn;
        U = Un;
        S = Sn;
      }
      cp_async_wait<0>();
    }
    grid_sync(bar, target);

    // ---- phase 3: y = A v for this CTA's rows, then w' and w'^T v
    for (int base = max(r, r0); base < r1; base += kChunk) {
      const int ai = tid % kChunk, sl = tid / kChunk;
      const int i = base + ai;
      const int ui = i / kHigh, hi = i % kHigh;
      T acc = 0;
      if (i < r1)                        // the row sums of row i's units
#pragma unroll 4
        for (int S = sl; S <= ui / kR; S += kSlices)
          acc += __ldcg(rowpart +
                        (strip_start<T>(S, nu) + ui - kR * S) * kHigh + hi);
      ys[sl][ai] = acc;
      __syncthreads();
      if (tid < kChunk && i < r1) {      // and the column sums of its strip
        T y = 0;
        for (int q = 0; q < kSlices; ++q) y += ys[q][tid];
        const int si = i / kW;
        const long long c_lo = strip_start<T>(si, nu) / per;
        const long long c_hi = (strip_start<T>(si + 1, nu) - 1) / per;
        for (long long c = c_lo; c <= c_hi; ++c)
          y += __ldcg(colpart + static_cast<size_t>(si + c) * kW + i % kW);
        __stcg(ybuf + i, y);
      }
      __syncthreads();
    }
    // V^T v and W^T v: warp k adds the partial sums of CTAs k, k + kWarps,
    // ... (lanes over the columns, so that a load of a warp is one run),
    // then the warps' sums are added in order; cred is the scratch.  Row
    // j + 1 of V and W, whose products phase 3 forms for the next column.
    if (j + 1 < bw)
      for (int l = tid; l < j; l += kThreads) {
        rowj[0][l] = __ldcg(Vt + static_cast<size_t>(l) * m + j + 1);
        rowj[1][l] = __ldcg(Wt + static_cast<size_t>(l) * m + j + 1);
      }
    for (int w0 = 0; w0 < 2 * j; w0 += kW) {
      const int nw = min(kW, 2 * j - w0);
      T acc[kW / 32];
#pragma unroll
      for (int q = 0; q < kW / 32; ++q) acc[q] = T(0);
#pragma unroll 3
      for (int c = warp; c < grid; c += kWarps) {
        const T* p = part_vw + static_cast<size_t>(c) * 2 * bw + w0;
#pragma unroll
        for (int q = 0; q < kW / 32; ++q)
          if (lane + 32 * q < nw) acc[q] += __ldcg(p + lane + 32 * q);
      }
#pragma unroll
      for (int q = 0; q < kW / 32; ++q)
        if (lane + 32 * q < nw) cred[warp][lane + 32 * q] = acc[q];
      __syncthreads();
      for (int w = tid; w < nw; w += kThreads) {
        T sum = 0;
        for (int k = 0; k < kWarps; ++k) sum += cred[k][w];
        tot[w0 + w] = sum;
      }
      __syncthreads();
    }
    T dsum = 0;
    for (int i = r0 + tid; i < r1; i += kThreads) {
      if (i < r) {
        __stcg(Wt + static_cast<size_t>(j) * m + i, T(0));
        continue;
      }
      // one pass over the row's V and W: the correction of A v, and the
      // next column's pending updates of columns < j
      T corr = 0, pend = 0;
#pragma unroll 8
      for (int l = 0; l < j; ++l) {
        const T vl = __ldcg(Vt + static_cast<size_t>(l) * m + i);
        const T wl = __ldcg(Wt + static_cast<size_t>(l) * m + i);
        corr += vl * tot[j + l] + wl * tot[l];
        pend += vl * rowj[1][l] + wl * rowj[0][l];
      }
      const T wp = tau * (__ldcg(ybuf + i) - corr);
      __stcg(wprime + i, wp);
      if (j + 1 < bw)
        __stcg(colbuf + i, a[static_cast<size_t>(i) * ld + j + 1] - pend);
      dsum += wp * __ldcg(Vt + static_cast<size_t>(j) * m + i);
    }
    dsum = warp_sum(dsum);
    if (lane == 0) wsum[warp] = dsum;
    __syncthreads();
    if (tid == 0) {
      T s = 0;
      for (int q = 0; q < kWarps; ++q) s += wsum[q];
      __stcg(part_dot + cta, s);
      if (cta == 0) {
        e_out[j] = beta;
        tau_out[j] = tau;
      }
    }
    grid_sync(bar, target);
  }
}

template <typename T>
int launch(const void* a, int ld, int m, int bw, int grid, int vec, void* vt,
           void* d, void* e, void* tau, void* scratch, void* bar,
           void* stream) {
  if (m < 1 || bw < 1 || bw > m || bw > kMaxB || ld < m || grid < 1)
    return cudaErrorInvalidValue;
  const void* kernel = reinterpret_cast<const void*>(panel_trd_kernel<T>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes<T>);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&a, &ld, &m, &bw, &vec, &vt, &d, &e, &tau, &scratch, &bar};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      kernel, dim3(grid), dim3(kThreads), args, kRingBytes<T>,
      static_cast<cudaStream_t>(stream)));
}

}  // namespace

// Words of scratch a launch of `grid` CTAs takes on an (m, m) block at
// panel width bw and itemsize isz (ops/householder.py::trd_scratch_words).
extern "C" int ek_panel_trd_scratch(int m, int bw, int grid, int isz) {
  return static_cast<int>(isz == 8 ? scratch_words<double>(m, bw, grid)
                                   : scratch_words<float>(m, bw, grid));
}

// a: the (m, m) trailing block, row stride ld (lower triangle read, not
// modified); vec: a and ld allow 16-byte loads; vt: (3 bw, m) output,
// every entry written; d, e, tau: bw, min(bw, m - 1), bw outputs (the
// column j = m - 1 writes d[j] only); scratch: ek_panel_trd_scratch words;
// bar: a zeroed unsigned word.  One cooperative launch of `grid` CTAs.
// Returns the CUDA error of the launch, else 0.
extern "C" int ek_panel_trd_f64(const void* a, int ld, int m, int bw,
                                int grid, int vec, void* vt, void* d, void* e,
                                void* tau, void* scratch, void* bar,
                                void* stream) {
  return launch<double>(a, ld, m, bw, grid, vec, vt, d, e, tau, scratch, bar,
                        stream);
}

extern "C" int ek_panel_trd_f32(const void* a, int ld, int m, int bw,
                                int grid, int vec, void* vt, void* d, void* e,
                                void* tau, void* scratch, void* bar,
                                void* stream) {
  return launch<float>(a, ld, m, bw, grid, vec, vt, d, e, tau, scratch, bar,
                       stream);
}
