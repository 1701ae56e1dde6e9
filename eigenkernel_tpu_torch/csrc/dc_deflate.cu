// The deflation scans of one level of the divide-and-conquer merge tree:
// type-2 (close-pole) deflation and the chain depths of its rotations, a
// warp per merge.
//
// Replaces: the two sequential lax.scans of
// eigenkernel_tpu/ops/dc.py::_merge_one, t2step (:186-224) and depth_step
// (:284-297).  They are not TPU kernels (XLA runs them as K-step scans);
// in eager PyTorch each step would be some 45 dependent launches.
//
// Computes, for each of the nb merges of a level, from its K sorted poles
// ds, rank-one weights us, type-1 mask alive and tolerance tol, the dlaed2
// recurrence over i = 0 .. K-1 with the carry (has, ip, dp, up), the last
// surviving entry:
//
//     r = sqrt(up^2 + u_i^2),  c = u_i / r,  s = up / r   (r = 0: r -> 1)
//     close = has & alive_i & |(d_i - dp) c s| <= tol
//
// and writes per step the finalized entry (fin_idx, fin_d, fin_u,
// fin_valid), the rotation record (rot_ip, rot_i, rot_c, rot_s, rot_m)
// and the rotation's chain depth (one more than the previous rotation's
// when that one's survivor is this one's partner, else 0; -1 where no
// rotation), and per merge the final carry.  The two scans of the JAX
// function run as one walk: a depth step needs only the record of its own
// step.
//
// Arithmetic: every product and sum is rounded on its own (__dmul_rn,
// __dadd_rn and the float forms: no contraction into FMAs), and sqrt and
// division are the IEEE ones, so the result equals, bit for bit, the plain
// PyTorch version (ops/dc.py::deflate_scan_plain), which evaluates the
// same expressions left to right with one rounding per operation.
//
// What bounds it on the card: the latency of the serial chain.  A merge is
// K dependent steps, each a sqrt, a division and a few products on the
// carry; the bytes (some 80 a step in float64) and the operations are far
// below the card's rates.  The bottom levels have many merges, the top one
// a single merge of K = n steps, so a level takes about K steps' latency.
//
// What the design does about it: nothing reaches the chain but the chain.
// A warp runs one merge, every lane the same scalar recurrence (no
// divergence); the lanes load 32 steps of inputs at a time, coalesced and
// a batch ahead, and shuffle each step's operands to every lane, so that
// no load sits between two steps; lane j keeps the records of step j of
// the batch and the warp writes them back coalesced.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // merges per block, one warp each
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double div(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float div(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }

// vals: (4, nb, K) fin_d, fin_u, rot_c, rot_s; idx: (4, nb, K) fin_idx,
// rot_ip, rot_i, depths; flags: (2, nb, K) fin_valid, rot_m; carry_v:
// (2, nb) dp, up; carry_i: (nb,) ip; carry_f: (nb,) has_p.
template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
    dc_deflate_kernel(const T* __restrict__ ds, const T* __restrict__ us,
                      const unsigned char* __restrict__ alive,
                      const T* __restrict__ tol, int nb, int K,
                      T* __restrict__ vals, long long* __restrict__ idx,
                      unsigned char* __restrict__ flags,
                      T* __restrict__ carry_v,
                      long long* __restrict__ carry_i,
                      unsigned char* __restrict__ carry_f) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= nb) return;  // a whole warp leaves together
  const size_t row = static_cast<size_t>(b) * K;
  const size_t plane = static_cast<size_t>(nb) * K;
  const T tl = tol[b];

  bool has = false;
  long long ip = 0, last_i = -1, last_d = 0;
  T dp = T(0), up = T(0);

  // the batch of 32 steps ahead, one step a lane
  T nd = T(0), nu = T(0);
  int na = 0;
  if (lane < K) {
    nd = ds[row + lane];
    nu = us[row + lane];
    na = alive[row + lane];
  }
  for (int i0 = 0; i0 < K; i0 += 32) {
    const T cd = nd, cu = nu;
    const int ca = na;
    if (i0 + 32 + lane < K) {
      nd = ds[row + i0 + 32 + lane];
      nu = us[row + i0 + 32 + lane];
      na = alive[row + i0 + 32 + lane];
    }
    const int steps = min(32, K - i0);
    T o_fd = T(0), o_fu = T(0), o_c = T(0), o_s = T(0);
    long long o_fi = 0, o_ip = 0, o_dep = -1;
    int o_fv = 0, o_m = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (j < steps) {  // the same on every lane
        const T di = __shfl_sync(kFull, cd, j);
        const T ui = __shfl_sync(kFull, cu, j);
        const bool al = __shfl_sync(kFull, ca, j) != 0;
        const long long i = i0 + j;
        const T r = sqrt_rn(add(mul(up, up), mul(ui, ui)));
        const T rs = r == T(0) ? T(1) : r;
        const T c = div(ui, rs);
        const T sn = div(up, rs);
        const bool close =
            has && al && fabs(mul(mul(sub(di, dp), c), sn)) <= tl;
        const bool fin_prev = has && al && !close;
        const bool fin_self = !al;
        const long long depth = (close && ip == last_i) ? last_d + 1 : 0;
        if (lane == j) {
          o_fv = close || fin_prev || fin_self;
          o_fi = fin_self ? i : ip;
          o_fd = close ? add(mul(mul(c, c), dp), mul(mul(sn, sn), di))
                       : (fin_self ? di : dp);
          o_fu = fin_prev ? up : T(0);
          o_ip = ip;
          o_c = c;
          o_s = sn;
          o_m = close;
          o_dep = close ? depth : -1;
        }
        if (close) {
          last_i = i;
          last_d = depth;
        }
        if (al) {
          dp = close ? add(mul(mul(sn, sn), dp), mul(mul(c, c), di)) : di;
          up = close ? r : ui;
          ip = i;
          has = true;
        }
      }
    }
    if (lane < steps) {
      const size_t at = row + i0 + lane;
      vals[at] = o_fd;
      vals[plane + at] = o_fu;
      vals[2 * plane + at] = o_c;
      vals[3 * plane + at] = o_s;
      idx[at] = o_fi;
      idx[plane + at] = o_ip;
      idx[2 * plane + at] = i0 + lane;
      idx[3 * plane + at] = o_dep;
      flags[at] = static_cast<unsigned char>(o_fv);
      flags[plane + at] = static_cast<unsigned char>(o_m);
    }
  }
  if (lane == 0) {
    carry_v[b] = dp;
    carry_v[nb + b] = up;
    carry_i[b] = ip;
    carry_f[b] = has;
  }
}

template <typename T>
int launch(const void* ds, const void* us, const void* alive,
           const void* tol, int nb, int K, void* vals, void* idx,
           void* flags, void* carry_v, void* carry_i, void* carry_f,
           void* stream) {
  if (nb < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (nb + kWarps - 1) / kWarps;
  dc_deflate_kernel<T><<<blocks, 32 * kWarps, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(ds), static_cast<const T*>(us),
      static_cast<const unsigned char*>(alive), static_cast<const T*>(tol),
      nb, K, static_cast<T*>(vals), static_cast<long long*>(idx),
      static_cast<unsigned char*>(flags), static_cast<T*>(carry_v),
      static_cast<long long*>(carry_i),
      static_cast<unsigned char*>(carry_f));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ds, us: (nb, K) of the working type; alive: (nb, K) bool (one byte);
// tol: (nb,).  Outputs as the kernel's comment says.  Returns
// cudaGetLastError() after the launch.
extern "C" int ek_dc_deflate_f64(const void* ds, const void* us,
                                 const void* alive, const void* tol, int nb,
                                 int K, void* vals, void* idx, void* flags,
                                 void* carry_v, void* carry_i, void* carry_f,
                                 void* stream) {
  return launch<double>(ds, us, alive, tol, nb, K, vals, idx, flags, carry_v,
                        carry_i, carry_f, stream);
}

extern "C" int ek_dc_deflate_f32(const void* ds, const void* us,
                                 const void* alive, const void* tol, int nb,
                                 int K, void* vals, void* idx, void* flags,
                                 void* carry_v, void* carry_i, void* carry_f,
                                 void* stream) {
  return launch<float>(ds, us, alive, tol, nb, K, vals, idx, flags, carry_v,
                       carry_i, carry_f, stream);
}
