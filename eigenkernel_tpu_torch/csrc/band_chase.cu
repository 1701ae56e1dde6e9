// Band -> tridiagonal bulge chase (Lang/Schwarz Householder chasing) on the
// stagger-4 wavefront schedule, as one persistent cooperative launch: the
// CTAs stride over the live lanes of a wavefront step tau, and a grid-wide
// barrier separates two steps.
//
// Replaces: eigenkernel_tpu/ops/pallas_chase.py::band_to_tridiag_pallas
// (Pallas kernel _chase_kernel / _chase_group), which keeps the whole
// banded state resident in TPU VMEM and runs all ~4n steps as one grid.
//
// State: the lower half of the symmetric band matrix with the bulge
// margin, lb[i, q] = A[i, i + q - 2b], q in [0, 2b], row-major with
// W = 2b + 1 words per row and n + 2b rows (rows >= n are zero).
//
// Schedule (ops/chase.py): a launch chases the sweeps [c_lo, c_hi] (the
// whole chase: [0, n - 3]).  At step tau, lane j chases sweep
// c = c_lo + tau/4 - j at band position t = tau%4 + 4j.  Its window starts
// at p = c + 1 + t b and touches rows [p, p + 2b) only; lanes sit 4b - 1
// rows apart, so the lanes of one step touch disjoint rows.  A lane is
// live when c_lo <= c <= min(c_hi, n-3), t < T, p < n-1 and jcol < n-1; a
// dead lane writes nothing.  4 (c_hi - c_lo) + T steps cover the range.
// Each step's arithmetic is the same in any launch, and sweep c's step t
// runs after every step of the older sweeps whose rows it reads, so
// ranges chased one launch after another give the bits of the whole chase;
// the state lb carries over from one launch to the next, and nothing else
// does (the window carry below stays inside a launch, the barrier counter
// is zeroed for each).
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
// What bounds it on the card: the chain of 4(n - 3) + T dependent steps
// (65,782 at n = 16384, b = 64), each a dozen block-wide barriers and a
// few dependent passes over a lane's faces (~2.5 b^2 words) in shared
// memory; the arithmetic (~104 GFLOP at n = 16384) and the bytes (the
// 17 MB state stays in L2; the 2.2 GB reflector store is written once)
// are far below that (obs/flops.py::bound_chase, a few ms).  What the
// design does about it:
// * one cooperative launch for the whole chase (no launch per step), the
//   grid min(live lanes, co-resident blocks), a hand-written grid barrier
//   between steps (a never-reset arrival counter: atomicAdd after a
//   __threadfence, a volatile spin); the cooperative launch guarantees
//   co-residency.  CTA x runs lanes x, x + grid, ...;
// * the "window" branch (4 b^2 + 8 b + 19 words of shared memory: b <= 84
//   in float64, b <= 119 in float32) stages rows [p, p + 2b) of the state
//   in shared memory (pitch 2b + 2: column walks free of bank conflicts),
//   with aligned 16-byte L2-only loads (ld.global.cg: L1 is not coherent
//   across SMs, and another SM's lane wrote these rows a step earlier),
//   runs the phases there and writes the faces back;
// * when every lane has its own CTA and a prefetch buffer fits (b <= 68
//   in float64, b <= 97 in float32), a lane's next step (same sweep, b
//   rows down) starts from this step's rows [b, 2b), which stay in shared
//   memory and are written back by that step, and from rows [2b, 3b),
//   which no lane touches in this step and which are prefetched with
//   cp.async while it runs: three steps in four load nothing from L2;
// * b = 64, the default, has its own build, with the index arithmetic
//   folded at compile time;
// * the "global" branch (larger b) runs the same phases on the state in
//   L2 directly, every load ld.global.cg;
// * phase 2 gives each of the 3b + 1 dot products an 8-lane group, 64
//   products in flight per pass at 512 threads, laid out free of bank
//   conflicts; phase 3 reads a row's words before it writes any.
// Control flow that reaches a __syncthreads or the grid barrier is uniform
// per CTA: liveness depends on the lane index only, and tau is read from
// shared memory by every thread.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemMax = 232448;          // a block's shared memory on sm_90
constexpr int kGroup = 8;                          // lanes per dot product
constexpr int kGroups = kThreads / kGroup;
static_assert(kGroups == 64, "phase 2 maps 64 groups onto blocks of 64");
constexpr int kBatch = 9;    // 16-byte loads in flight a thread

// Shared-memory words of the scratch: v, dv, cl, cr, one word per warp and
// two scalars; the global branch needs no more.
__host__ __device__ constexpr long scratch_words(int b) {
  return 4L * b + 1 + kWarps + 2;
}
// Shared-memory words of the window branch: rows [p, p + 2b) at a pitch of
// 2b + 2 and the scratch (ops/chase.py::window_words).
__host__ __device__ constexpr long window_words(int b) {
  return 2L * b * (2 * b + 2) + scratch_words(b);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__device__ __forceinline__ T group_sum(T x) {      // over kGroup lanes
  for (int o = kGroup / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
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

// Rows [p, p + 2b) of the state, element (r, q) = lb[p + r, q]: in shared
// memory at base[r * pitch + q] (kWin), or in the global state, through L2.
template <typename T, bool kWin>
struct Rows {
  T* base;
  int pitch;
  __device__ __forceinline__ T ld(int r, int q) const {
    if constexpr (kWin) return base[r * pitch + q];
    else return __ldcg(base + static_cast<size_t>(r) * pitch + q);
  }
  __device__ __forceinline__ void st(int r, int q, T x) const {
    if constexpr (kWin) base[r * pitch + q] = x;
    else __stcg(base + static_cast<size_t>(r) * pitch + q, x);
  }
};

// The q range a lane touches in row r of its window: the left strip and D
// in rows r < b, the fill in rows b + r.
__device__ __forceinline__ void face_cols(int r, int b, int& lo, int& hi) {
  if (r < b) {
    lo = b - 1 - r;
    hi = 2 * b;
  } else {
    lo = 2 * b - r;       // b - (r - b)
    hi = 3 * b - 1 - r;   // 2b - 1 - (r - b)
  }
}

// Grid-wide barrier: *bar counts every arrival of the launch and never
// resets, so barrier number i is passed when it reaches i * gridDim.x
// (compared modulo 2^32).  `target` is that count, the same in every
// thread.  One atomic and one L2 poll on the critical path.
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

template <typename T>
struct Vec16;   // 16 bytes of T, for the aligned L2 loads
template <>
struct Vec16<double> {
  using type = double2;
  __device__ static double get(const double2& v, int e) {
    return e ? v.y : v.x;
  }
};
template <>
struct Vec16<float> {
  using type = float4;
  __device__ static float get(const float4& v, int e) {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
  }
};

// Load words [gb, ge) of the 2b x W block at grow (rows [p, p + 2b) of
// the state, contiguous there) into the window (pitch W + 1), all of them,
// faces or not.  The threads walk the range in aligned 16-byte chunks
// through L2 (ld.global.cg: L1 is not coherent across SMs), kBatch chunks
// in flight per thread; a chunk's words map to (row r, column q) with
// (r, q) carried along, no division.
template <typename T>
__device__ __forceinline__ void load_rows(const T* grow, T* win, int b,
                                          int gb, int ge) {
  using VT = typename Vec16<T>::type;
  constexpr int kV = 16 / sizeof(T);
  const int W = 2 * b + 1, tid = threadIdx.x;
  // chunk c covers words kV c - lead + [0, kV) of the block
  const int lead =
      static_cast<int>(reinterpret_cast<size_t>(grow) % 16 / sizeof(T));
  const int c_lo = (gb + lead) / kV, c_hi = (ge + lead + kV - 1) / kV;
  const VT* base = reinterpret_cast<const VT*>(grow - lead);
  const int step = kV * kThreads, dr = step / W, dq = step % W;
  const int g0 = kV * (c_lo + tid) - lead;
  int r = g0 >= 0 ? g0 / W : -1, q = g0 >= 0 ? g0 % W : g0 + W;
  for (int c0 = c_lo + tid; c0 < c_hi; c0 += kThreads * kBatch) {
    VT buf[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = c0 + u * kThreads;
      if (c < c_hi) buf[u] = __ldcg(base + c);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = c0 + u * kThreads;
      if (c < c_hi) {
        int rr = r, qq = q;
#pragma unroll
        for (int e = 0; e < kV; ++e) {
          const int g = kV * c - lead + e;
          if (g >= gb && g < ge) win[g + rr] = Vec16<T>::get(buf[u], e);
          if (++qq == W) {
            qq = 0;
            ++rr;
          }
        }
      }
      r += dr;
      q += dq;
      if (q >= W) {
        q -= W;
        ++r;
      }
    }
  }
}

// Write the faces in the first `rows` rows of the window back to the
// state, word by word (st.global.cg), consecutive threads on consecutive
// words of the block.
template <typename T>
__device__ __forceinline__ void store_faces(T* grow, const T* win, int b,
                                            int rows) {
  const int W = 2 * b + 1, tid = threadIdx.x;
  const int dr = kThreads / W, dq = kThreads % W;
  int r = tid / W, q = tid % W;
  for (int g = tid; g < rows * W; g += kThreads) {
    int lo, hi;
    face_cols(r, b, lo, hi);
    if (q >= lo && q <= hi) __stcg(grow + g, win[g + r]);
    r += dr;
    q += dq;
    if (q >= W) {
      q -= W;
      ++r;
    }
  }
}

// Copy a b x W block from src (row pitch ps) to dst (row pitch W + 1),
// kBatch reads in flight per thread before their writes.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int ps,
                                          int b) {
  const int W = 2 * b + 1, P = W + 1, tid = threadIdx.x, words = b * W;
  const int dr = kThreads / W, dq = kThreads % W;
  int r = tid / W, q = tid % W;
  for (int g0 = tid; g0 < words; g0 += kThreads * kBatch) {
    T buf[kBatch];
    int at[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool ok = g0 + u * kThreads < words;
      at[u] = ok ? r * P + q : -1;
      buf[u] = ok ? src[r * ps + q] : T(0);
      r += dr;
      q += dq;
      if (q >= W) {
        q -= W;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (at[u] >= 0) dst[at[u]] = buf[u];
  }
}

// Words of the prefetch buffer: rows [b, 2b) of the next window, b x W,
// and room to align their first word down to 16 bytes.
__host__ __device__ constexpr long pref_words(int b, int v) {
  return static_cast<long>(b) * (2 * b + 1) + 2 * v;
}

// Offset (in words of T) of the prefetch buffer: after the window and its
// scratch, on a 16-byte boundary.
template <typename T>
__host__ __device__ constexpr long pref_offset(int b) {
  return (window_words(b) + 16 / sizeof(T) - 1) / (16 / sizeof(T)) *
         (16 / sizeof(T));
}

// Start copying `words` words of the state at src into pref, 16-byte
// cp.async copies through L2 (.cg); pref[lead + g] is word g, lead the
// words src lies past a 16-byte boundary.  One commit group per thread.
template <typename T>
__device__ __forceinline__ void prefetch_rows(const T* src, T* pref,
                                              int words) {
  constexpr int kV = 16 / sizeof(T);
  const int lead =
      static_cast<int>(reinterpret_cast<size_t>(src) % 16 / sizeof(T));
  const int chunks = (lead + words + kV - 1) / kV;
  const T* base = src - lead;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(pref + kV * c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(base + kV * c));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Stage the window of a lane whose previous step (the same sweep, b rows
// up) left its rows [b, 2b) whole in the window's rows [b, 2b) and
// prefetched the rows after them (from grow + b W) into pref: move the
// first up, then copy the second in.  No load from L2 on this path.
template <typename T>
__device__ __forceinline__ void stage_carried(const T* grow, T* win,
                                              const T* pref, int b) {
  const int W = 2 * b + 1, P = W + 1;
  const int lead = static_cast<int>(
      reinterpret_cast<size_t>(grow + b * W) % 16 / sizeof(T));
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  copy_rows(win, win + b * P, P, b);
  __syncthreads();          // rows [b, 2b) are read before they are filled
  copy_rows(win + b * P, pref + lead, W, b);
}

// Phases 2 and 3 of a lane whose reflector (v, th) is not the identity.
template <typename T, bool kWin, int kB>
__device__ __forceinline__ void update(const Rows<T, kWin>& A, const T* v,
                                       T* dv, T* cl, T* cr, T* red, T th,
                                       int b_arg) {
  const int b = kB > 0 ? kB : b_arg;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // ---- phase 2: every coefficient, before any element is written; an
  // 8-lane group per dot product.  The four groups of warp w take outputs
  // w % 8 + 32 (w / 8) + {0, 8, 16, 24} of each block of 64: rows 8 apart
  // put their words on the two halves of the banks, no conflicts.
  const int gl = lane % kGroup, nseg = (b + kGroup - 1) / kGroup;
  const int operm = (lane / kGroup) * 8 + warp % 8 + 32 * (warp / 8);
  // every pass's loads before any store: the sums wait in registers
  constexpr int kPasses = kB > 0 ? (3 * kB + 1 + kGroups - 1) / kGroups : 1;
  const int passes = (3 * b + 1 + kGroups - 1) / kGroups;
  for (int pb = 0; pb < passes; pb += kPasses) {
    T acc[kPasses];
#pragma unroll
    for (int k = 0; k < kPasses; ++k) {
      const int o = (pb + k) * kGroups + operm;
      acc[k] = T(0);
      if (o < b) {                       // dv[o] = sum_s D[o, s] v[s]
        const int r = o;
        for (int i = 0; i < nseg; ++i) {
          const int s = gl + kGroup * i;
          if (s < b)
            acc[k] += (s <= r ? A.ld(r, s - r + 2 * b)
                              : A.ld(s, r - s + 2 * b)) * v[s];
        }
      } else if (o < 2 * b + 1) {        // cl[s] = sum_r v[r] L[r, s]
        const int s = o - b;
        for (int i = 0; i < nseg; ++i) {
          const int r = gl + kGroup * i;
          if (r < b) acc[k] += v[r] * A.ld(r, b - 1 + s - r);
        }
      } else if (o < 3 * b + 1) {        // cr[r] = sum_s F[r, s] v[s]
        const int r = o - (2 * b + 1);
        for (int i = 0; i < nseg; ++i) {
          const int s = gl + kGroup * i;
          if (s < b) acc[k] += A.ld(b + r, b + s - r) * v[s];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kPasses; ++k) {
      const int o = (pb + k) * kGroups + operm;
      const T sum = group_sum(acc[k]);
      if (gl == 0) {
        if (o < b) dv[o] = sum;
        else if (o < 2 * b + 1) cl[o - b] = sum;
        else if (o < 3 * b + 1) cr[o - (2 * b + 1)] = sum;
      }
    }
  }
  __syncthreads();
  T pv = T(0);
  for (int r = tid; r < b; r += kThreads) pv += v[r] * dv[r];
  const T vdv = block_sum(pv, red);
  const T tt_vdv = th * th * vdv;

  // ---- phase 3: the two-sided update, a warp per row; a row's words are
  // all read before any is written
  constexpr int kSeg = kB > 0 ? (kB + 1 + 31) / 32 : 1;
  const int nrow = (b + 1 + 31) / 32;
  for (int r = warp; r < b; r += kWarps) {
    const T vr = v[r], dvr = dv[r], crr = cr[r];
    for (int i0 = 0; i0 < nrow; i0 += kSeg) {
      T d[kSeg] = {}, f[kSeg] = {}, l[kSeg] = {};
#pragma unroll
      for (int k = 0; k < kSeg; ++k) {
        const int s = lane + 32 * (i0 + k);
        if (s <= r) d[k] = A.ld(r, s - r + 2 * b);
        if (s < b) f[k] = A.ld(b + r, b + s - r);
        if (s <= b) l[k] = A.ld(r, b - 1 + s - r);
      }
#pragma unroll
      for (int k = 0; k < kSeg; ++k) {
        const int s = lane + 32 * (i0 + k);
        if (s <= r)                                  // D, lower half
          A.st(r, s - r + 2 * b, d[k] - th * (vr * dv[s]) -
                                     th * (dvr * v[s]) +
                                     tt_vdv * (vr * v[s]));
        if (s < b)                                   // fill rows
          A.st(b + r, b + s - r, f[k] - th * (crr * v[s]));
        if (s <= b)                                  // left strip
          A.st(r, b - 1 + s - r, l[k] - th * (vr * cl[s]));
      }
    }
  }
}

template <typename T, bool kWin, int kB>
__device__ bool chase_lane(T* __restrict__ lb, T* __restrict__ hv,
                           T* __restrict__ ht, T* smem, int n, int b_arg,
                           int nt, int c_lo, int tau, int j, bool carried,
                           bool may_carry) {
  // may_carry: a CTA runs one lane a step, the same lane from one step to
  // the next, and a prefetch buffer fits
  // hv and ht hold sweeps c_lo.. of the range: row c - c_lo is sweep c
  const int b = kB > 0 ? kB : b_arg;
  const int t = (tau % 4) + 4 * j;
  const int c = c_lo + tau / 4 - j;       // in [c_lo, c_hi] by the caller
  const int p = c + 1 + t * b;
  const int jcol = (t == 0) ? c : p - b;
  if (!(c <= n - 3 && t <= nt - 1 && p < n - 1 && jcol < n - 1))
    return false;                         // dead lane: uniform per CTA

  const int W = 2 * b + 1, tid = threadIdx.x;
  T* win = smem;
  T* v = smem + (kWin ? 2 * b * (2 * b + 2) : 0);   // (b,)
  T* dv = v + b;                                    // (b,)
  T* cl = dv + b;                                   // (b + 1,)
  T* cr = cl + b + 1;                               // (b,)
  T* red = cr + b;                                  // (kWarps,)
  T* sc = red + kWarps;                             // tau, alpha - beta
  T* grow = lb + static_cast<size_t>(p) * W;
  // A[p + r, col] is element (r, col - (p + r) + 2b) of A
  const Rows<T, kWin> A{kWin ? win : grow, kWin ? W + 1 : W};
  // the next step of this lane (t + 1, same sweep, window b rows down)
  // starts from this window's rows [b, 2b), which it alone touches in
  // between: they stay here and are written back by that step; the rows
  // after them, which no lane touches in this step, are prefetched
  const bool carry = kWin && may_carry && tau % 4 != 3 && t + 1 <= nt - 1 &&
                     p + b < n - 1;
  T* pref = smem + pref_offset<T>(b);

  if constexpr (kWin) {
    if (carried)
      stage_carried(grow, win, pref, b);
    else
      load_rows(grow, win, b, 0, 2 * b * W);
    __syncthreads();
    if (carry) prefetch_rows(grow + 2 * b * W, pref, b * W);
  }

  // ---- phase 1: the Householder of the pivot column
  const int qcol = jcol - p + 2 * b;      // q of (p + r, jcol) is qcol - r
  T part = T(0);
  for (int r = tid; r < b; r += kThreads) {
    const T x = A.ld(r, qcol - r);
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
  const size_t at = static_cast<size_t>(c - c_lo) * nt + t;
  T* hv_out = hv + at * b;
  for (int r = tid; r < b; r += kThreads) {
    const T vr = live_v ? (r == 0 ? T(1) : v[r] / sc[1]) : T(0);
    hv_out[r] = vr;
    v[r] = vr;
  }
  if (tid == 0) ht[at] = th;
  __syncthreads();
  if (th != T(0))           // else the identity: the state stays as it is
    update<T, kWin, kB>(A, v, dv, cl, cr, red, th, b);
  if constexpr (kWin) {
    __syncthreads();
    store_faces(grow, win, b, carry ? b : 2 * b);
  }
  return carry;
}


template <typename T, bool kWin, int kB>
__global__ void __launch_bounds__(kThreads)
    chase_kernel(T* __restrict__ lb, T* __restrict__ hv, T* __restrict__ ht,
                 unsigned* bar, int n, int b, int nt, int c_lo, int c_hi,
                 int pref) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int max_lane = (nt + 3) / 4 - 1;
  const int span = c_hi - c_lo;           // the range's sweeps, less one
  const int tau_max = 4 * span + nt;
  unsigned target = 0;
  // at most min(max_lane, span) + 1 lanes are live at a step, consecutive
  // in j: a grid of that many CTAs runs each on a CTA of its own, from one
  // step to the next
  const int live = (max_lane < span ? max_lane : span) + 1;
  const bool may_carry = pref && static_cast<int>(gridDim.x) >= live;
  bool carried = false;   // never across launches: a lane's carried step
                          // is in its own range
  for (int tau = 0; tau < tau_max; ++tau) {
    // lanes with c_lo <= c <= c_hi and t <= nt-1; liveness is rechecked
    // inside
    int j0 = tau / 4 - span;
    if (j0 < 0) j0 = 0;
    int j1 = tau / 4;
    const int jt = nt - 1 - tau % 4;
    if (jt < 0) continue;                 // the same for every CTA
    if (jt / 4 < j1) j1 = jt / 4;
    if (max_lane < j1) j1 = max_lane;
    if (j1 < j0) continue;
    // CTA x runs lanes x, x + grid, ...: with a grid of at least the
    // lanes of a step, always the same lane, whose window rows can carry
    bool next = false;
    for (int j = static_cast<int>(blockIdx.x); j <= j1; j += gridDim.x) {
      if (j < j0) continue;
      next = chase_lane<T, kWin, kB>(lb, hv, ht, smem, n, b, nt, c_lo, tau,
                                     j, carried, may_carry);
      __syncthreads();                    // smem is reused by the next lane
    }
    carried = next;
    grid_sync(bar, target);
  }
}

// The kernel of a branch; the window branch has its own build for the
// default bandwidth 64, whose index arithmetic folds at compile time.
template <typename T>
const void* kernel_of(int b, int window) {
  if (!window) return reinterpret_cast<const void*>(chase_kernel<T, false, 0>);
  if (b == 64) return reinterpret_cast<const void*>(chase_kernel<T, true, 64>);
  return reinterpret_cast<const void*>(chase_kernel<T, true, 0>);
}

// Bytes of shared memory, and whether the window branch has room for the
// prefetch buffer of the carried windows.
template <typename T>
size_t smem_of(int b, int window, int* pref) {
  *pref = 0;
  if (!window) return static_cast<size_t>(scratch_words(b)) * sizeof(T);
  const size_t with = static_cast<size_t>(
      pref_offset<T>(b) + pref_words(b, 16 / sizeof(T))) * sizeof(T);
  if (with <= kSmemMax) {
    *pref = 1;
    return with;
  }
  return static_cast<size_t>(window_words(b)) * sizeof(T);
}

template <typename T>
int prepare(int b, int window, size_t* smem, int* pref) {
  *smem = smem_of<T>(b, window, pref);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel_of<T>(b, window), cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(*smem)));
}

template <typename T>
int resident(int b, int window, int* blocks) {
  size_t smem = 0;
  int pref = 0;
  int err = prepare<T>(b, window, &smem, &pref);
  if (err != 0) return err;
  int dev = 0, per_sm = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel_of<T>(b, window), kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  *blocks = per_sm * sms;
  return 0;
}

template <typename T>
int launch(void* lb, void* hv, void* ht, void* bar, int n, int b, int nt,
           int c_lo, int c_hi, int window, int grid, void* stream) {
  if (c_lo < 0 || c_hi < c_lo || c_hi > n - 3) return cudaErrorInvalidValue;
  size_t smem = 0;
  int pref = 0;
  int err = prepare<T>(b, window, &smem, &pref);
  if (err != 0) return err;
  void* args[] = {&lb, &hv, &ht, &bar, &n, &b, &nt, &c_lo, &c_hi, &pref};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      kernel_of<T>(b, window), dim3(grid), dim3(kThreads), args, smem,
      static_cast<cudaStream_t>(stream)));
}

}  // namespace

// *blocks gets the number of CTAs of the chase kernel (branch `window`,
// bandwidth b) that can be co-resident on the current device.
extern "C" int ek_band_chase_resident_f64(int b, int window, int* blocks) {
  return resident<double>(b, window, blocks);
}

extern "C" int ek_band_chase_resident_f32(int b, int window, int* blocks) {
  return resident<float>(b, window, blocks);
}

// lb (n + 2b, 2b + 1) lower band state, updated in place; hv
// (c_hi - c_lo + 1, nt, b) and ht (c_hi - c_lo + 1, nt) zero-filled
// reflector stores of the sweeps [c_lo, c_hi] (0 <= c_lo <= c_hi <= n - 3),
// row c - c_lo written at every live (c, t); bar: a zeroed unsigned word
// for the grid barrier.  Chases those sweeps in one cooperative launch of
// `grid` CTAs (branch `window`).  Returns the CUDA error of the launch,
// else 0.
extern "C" int ek_band_chase_f64(void* lb, void* hv, void* ht, void* bar,
                                 int n, int b, int nt, int c_lo, int c_hi,
                                 int window, int grid, void* stream) {
  return launch<double>(lb, hv, ht, bar, n, b, nt, c_lo, c_hi, window, grid,
                        stream);
}

extern "C" int ek_band_chase_f32(void* lb, void* hv, void* ht, void* bar,
                                 int n, int b, int nt, int c_lo, int c_hi,
                                 int window, int grid, void* stream) {
  return launch<float>(lb, hv, ht, bar, n, b, nt, c_lo, c_hi, window, grid,
                       stream);
}
