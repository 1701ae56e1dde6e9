// Batched Sturm-count bisection for eigenvalues of a symmetric tridiagonal
// matrix: a target eigenvalue per block of one or more warps, several
// bisection levels per pass over the rows.
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
// What bounds it on the card: the latency of the serial division chain.
// Sequential bisection is iters * n dependent steps per target (62 * n in
// float64, 30 * n in float32), each an IEEE division, a subtraction and a
// compare; the operations (3 * iters * n * k) and the bytes (d, e2 once)
// are far below the card's rates, and k = 500 targets are far too few
// for a thread each to fill 132 SMs.
//
// What the design does about it: bisection levels in parallel.  A block
// of W warps (W = 1 or 2: `warps`) holds one target's [lo, hi] and, in
// one pass over the n rows, counts at every interior node of the depth-D
// bisection tree below that interval, D = 5 + log2 W: thread s holds node
// s in heap order (level L = floor(log2(s + 1)), position p = s + 1 - 2^L,
// children 2s + 1 below and 2s + 2 above the node's point).  A thread
// reaches its node's point by bisecting [lo, hi] along the bits of p, most
// significant first, with exactly the arithmetic of sequential bisection
// (mid = 0.5 (lo + hi), then lo = mid for a 1 bit, hi = mid for a 0 bit);
// the counts meet in shared memory and every thread walks the tree on the
// rule count >= idx + 1 => hi = mid.  The points counted are the points
// sequential bisection visits, so the result is bit for bit that of
// one-step bisection; only the number of dependent passes falls, to
// ceil(iters / D): 13 or 11 in float64 and 6 or 5 in float32.  The warps'
// chains are independent, so they overlap on the SM; the host takes W = 2
// while the grid stays within 8 warps an SM (k <= 528 on 132 SMs), where a
// step's latency is still flat (tools/div_chain.py), else W = 1.  d and e2
// reach the chain without a load on it: a warp loads 32 rows at a time,
// one per lane and a batch ahead, and shuffles them to every lane 8 rows
// at a time, a group ahead, so that only the division chain runs between
// two steps.

#include <cuda_runtime.h>

#include <limits>

namespace {

constexpr int kMaxWarps = 2;  // warps per target: trees of depth 5 or 6
constexpr unsigned kFull = 0xffffffffu;

// Keep v in a register from here on: the compiler may neither sink the
// instruction that makes it towards its use nor make it again there.
__device__ __forceinline__ void pin(double& v) { asm volatile("" : "+d"(v)); }
__device__ __forceinline__ void pin(float& v) { asm volatile("" : "+f"(v)); }

// One step of the count: q <- (d_i - x) - e2_i / q, floored; count q < 0.
// The floor keeps the sign, so q < 0 before it is q < 0 after it.
template <typename T>
__device__ __forceinline__ void sturm_step(T& q, int& cnt, T dm, T ei,
                                           T pivmin, T npiv) {
  T qn = dm - ei / q;
  const bool neg = qn < T(0);
  if (fabs(qn) < pivmin) qn = neg ? npiv : pivmin;
  cnt += neg ? 1 : 0;
  q = qn;
}

// The Sturm count at x over all n rows, for the calling warp's lane.  The
// rows come 32 at a time, one per lane, loaded a batch ahead; a full batch
// runs as four groups of 8 steps, each group's rows shuffled to every
// lane while the group before it runs and its d_i - x formed before its
// first step, so that nothing but the division chain sits between two
// steps.
template <typename T>
__device__ __forceinline__ int sturm_count(const T* __restrict__ d,
                                           const T* __restrict__ e2, int n,
                                           T x, T pivmin, int lane) {
  constexpr int kGroup = 8;
  T npiv = -pivmin;
  pin(npiv);
  T q = T(1);
  int cnt = 0;
  T bd = lane < n ? __ldg(d + lane) : T(0);  // rows [i0, i0 + 32)
  T be = lane < n ? __ldg(e2 + lane) : T(0);
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int nx = i0 + 32 + lane;  // the next batch
    const T nd = nx < n ? __ldg(d + nx) : T(0);
    const T ne = nx < n ? __ldg(e2 + nx) : T(0);
    if (n - i0 >= 32) {
      T gd[kGroup], ge[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        gd[u] = __shfl_sync(kFull, bd, u);
        ge[u] = __shfl_sync(kFull, be, u);
      }
#pragma unroll 1
      for (int g = kGroup; g <= 32; g += kGroup) {
        T hd[kGroup], he[kGroup];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {  // lane 32 + u wraps: unused
          hd[u] = __shfl_sync(kFull, bd, (g + u) & 31);
          he[u] = __shfl_sync(kFull, be, (g + u) & 31);
        }
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          gd[u] -= x;
          pin(gd[u]);
          pin(ge[u]);
        }
#pragma unroll
        for (int u = 0; u < kGroup; ++u)
          sturm_step(q, cnt, gd[u], ge[u], pivmin, npiv);
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          gd[u] = hd[u];
          ge[u] = he[u];
        }
      }
    } else {
      for (int r = 0; r < n - i0; ++r)
        sturm_step(q, cnt, __shfl_sync(kFull, bd, r) - x,
                   __shfl_sync(kFull, be, r), pivmin, npiv);
    }
    bd = nd;
    be = ne;
  }
  return cnt;
}

template <typename T>
__global__ void __launch_bounds__(32 * kMaxWarps)
    sturm_bisect_kernel(const T* __restrict__ d, const T* __restrict__ e2,
                        const int* __restrict__ idx,
                        const T* __restrict__ bounds, T* __restrict__ out,
                        int n, int iters, T pivmin) {
  __shared__ int s_cnt[32 * kMaxWarps];
  const int slot = threadIdx.x;  // heap index of this thread's node
  const int lane = slot & 31;
  const int depth_max = 31 - __clz(static_cast<int>(blockDim.x));
  const int target = idx[blockIdx.x] + 1;
  const int level = 31 - __clz(slot + 1);
  const int pos = slot + 1 - (1 << level);
  T lo = bounds[0];
  T hi = bounds[1];
  for (int done = 0; done < iters; done += depth_max) {
    const int depth = min(depth_max, iters - done);
    // a warp that holds no node of this pass's tree (2^depth - 1 nodes)
    // skips the count as a whole
    if (slot - lane < (1 << depth) - 1) {
      T l = lo, h = hi;
      for (int s = level - 1; s >= 0; --s) {
        const T m = T(0.5) * (l + h);
        if ((pos >> s) & 1) {
          l = m;
        } else {
          h = m;
        }
      }
      s_cnt[slot] = sturm_count(d, e2, n, T(0.5) * (l + h), pivmin, lane);
    }
    __syncthreads();
    int j = 0;  // heap index of the node on the target's path
    for (int s = 0; s < depth; ++s) {
      const T mid = T(0.5) * (lo + hi);
      if (s_cnt[j] >= target) {
        hi = mid;
        j = 2 * j + 1;
      } else {
        lo = mid;
        j = 2 * j + 2;
      }
    }
    __syncthreads();  // the next pass overwrites s_cnt
  }
  if (slot == 0) out[blockIdx.x] = T(0.5) * (lo + hi);
}

template <typename T>
int launch(const void* d, const void* e2, const void* idx,
           const void* bounds, void* out, int n, int k, int iters,
           int warps, void* stream) {
  if (warps != 1 && warps != kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  const T pivmin = T(4) * std::numeric_limits<T>::min();
  sturm_bisect_kernel<T><<<k, 32 * warps, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(d), static_cast<const T*>(e2),
      static_cast<const int*>(idx), static_cast<const T*>(bounds),
      static_cast<T*>(out), n, iters, pivmin);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// e2 has n entries: e2[0] = 0 and e2[i] = e[i-1]^2.  bounds holds (lo, hi)
// on the device.  warps (1 or 2) per target sets the tree depth a pass
// covers, 5 or 6 levels.  Returns cudaGetLastError() after the launch.
extern "C" int ek_sturm_bisect_f64(const void* d, const void* e2,
                                   const void* idx, const void* bounds,
                                   void* out, int n, int k, int iters,
                                   int warps, void* stream) {
  return launch<double>(d, e2, idx, bounds, out, n, k, iters, warps,
                        stream);
}

extern "C" int ek_sturm_bisect_f32(const void* d, const void* e2,
                                   const void* idx, const void* bounds,
                                   void* out, int n, int k, int iters,
                                   int warps, void* stream) {
  return launch<float>(d, e2, idx, bounds, out, n, k, iters, warps,
                       stream);
}

// The most warps a target a launch takes (ops/sturm.py's MAX_WARPS).
extern "C" int ek_sturm_max_warps() { return kMaxWarps; }
