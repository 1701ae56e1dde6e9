// The deflation scans of one level of the divide-and-conquer merge tree:
// type-2 (close-pole) deflation and the chain depths of its rotations, a
// CTA per merge that speculates every step at once and then resolves the
// steps that follow a close one.
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
// What bounds it on the card: the steps that truly depend on each other.
// An alive step that is not close resets the carry to (true, i, d_i, u_i),
// which depends on the inputs alone; only a close step passes on a carry
// computed from the one before it.  So the serial floor of a merge is its
// chain of close steps (each a sqrt, two divisions and a few products),
// not its K steps; the bytes (some 80 a step in float64) are far below the
// memory rate.
//
// What the design does about it (speculate, then resolve):
// 1. The CTA marks the alive steps in a bitmask (a ballot a warp) and
//    finds, for every step, the last alive step before it (a max-scan of
//    the mask's words).
// 2. Speculate: every step at once computes its records as if its last
//    alive step before it had not been close, i.e. from the reset carry of
//    that step (or the initial carry where there is none), writes them,
//    coalesced, and marks the close steps in a second bitmask.  Where the
//    assumption holds the records are final: a close step found this way
//    starts a chain of depth 0.
// 3. Resolve: one warp walks the close mask.  It skips runs without a
//    close step 1,024 steps a ballot; at a close step it takes the real
//    carry and recomputes the steps one at a time, as the scan does (the
//    32 steps of a batch loaded at once and shuffled to every lane), until
//    an alive step comes out not close: from there the speculation holds
//    again.  The chain depths fall out of the same walk.
// The expressions and operands of every step are the scan's, so are the
// bits.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
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

// One step of the scan from the carry (has, ip, dp, up): the records of
// step i and the carry it passes on.
template <typename T>
struct Step {
  T r, c, sn, fin_d, fin_u, dp, up;
  bool close, fin_prev, fin_self;
};

template <typename T>
__device__ __forceinline__ Step<T> step(T di, T ui, bool al, T tl, bool has,
                                        T dp, T up) {
  Step<T> o;
  o.r = sqrt_rn(add(mul(up, up), mul(ui, ui)));
  const T rs = o.r == T(0) ? T(1) : o.r;
  o.c = div(ui, rs);
  o.sn = div(up, rs);
  o.close = has && al && fabs(mul(mul(sub(di, dp), o.c), o.sn)) <= tl;
  o.fin_prev = has && al && !o.close;
  o.fin_self = !al;
  o.fin_d = o.close ? add(mul(mul(o.c, o.c), dp), mul(mul(o.sn, o.sn), di))
                    : (o.fin_self ? di : dp);
  o.fin_u = o.fin_prev ? up : T(0);
  o.dp = al ? (o.close ? add(mul(mul(o.sn, o.sn), dp), mul(mul(o.c, o.c), di))
                       : di)
            : dp;
  o.up = al ? (o.close ? o.r : ui) : up;
  return o;
}

// The output planes of one merge: vals (4, nb, K) fin_d, fin_u, rot_c,
// rot_s; idx (4, nb, K) fin_idx, rot_ip, rot_i, depths; flags (2, nb, K)
// fin_valid, rot_m.
template <typename T>
struct Out {
  T* vals;
  long long* idx;
  unsigned char* flags;
  size_t plane;

  __device__ void put(size_t at, long long i, const Step<T>& o, long long ip,
                      long long depth) const {
    vals[at] = o.fin_d;
    vals[plane + at] = o.fin_u;
    vals[2 * plane + at] = o.c;
    vals[3 * plane + at] = o.sn;
    idx[at] = o.fin_self ? i : ip;
    idx[plane + at] = ip;
    idx[2 * plane + at] = i;
    idx[3 * plane + at] = depth;
    flags[at] = static_cast<unsigned char>(o.close || o.fin_prev ||
                                           o.fin_self);
    flags[plane + at] = static_cast<unsigned char>(o.close);
  }
};

// carry_v: (2, nb) dp, up; carry_i: (nb,) ip; carry_f: (nb,) has_p.
// Dynamic shared memory: three words a 32 steps (the alive mask, the close
// mask, the last alive step up to the end of each word).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    dc_deflate_kernel(const T* __restrict__ ds, const T* __restrict__ us,
                      const unsigned char* __restrict__ alive,
                      const T* __restrict__ tol, int nb, int K,
                      T* __restrict__ vals, long long* __restrict__ idx,
                      unsigned char* __restrict__ flags,
                      T* __restrict__ carry_v,
                      long long* __restrict__ carry_i,
                      unsigned char* __restrict__ carry_f) {
  extern __shared__ unsigned words[];
  const int nw = (K + 31) / 32;
  unsigned* alive_bits = words;
  unsigned* close_bits = words + nw;
  int* last_upto = reinterpret_cast<int*>(words + 2 * nw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int b = blockIdx.x;
  const size_t row = static_cast<size_t>(b) * K;
  const Out<T> out{vals, idx, flags, static_cast<size_t>(nb) * K};
  const T tl = tol[b];

  // 1. the alive mask, then the last alive step up to each word's end
  for (int wd = warp; wd < nw; wd += warps) {
    const int i = wd * 32 + lane;
    const unsigned bits = __ballot_sync(kFull, i < K && alive[row + i]);
    if (lane == 0) alive_bits[wd] = bits;
  }
  __syncthreads();
  if (warp == 0) {
    int carry = -1;
    for (int w0 = 0; w0 < nw; w0 += 32) {
      const int wd = w0 + lane;
      const unsigned bits = wd < nw ? alive_bits[wd] : 0u;
      int last = bits ? wd * 32 + 31 - __clz(bits) : -1;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(kFull, last, d);
        if (lane >= d) last = max(last, o);
      }
      last = max(last, carry);
      if (wd < nw) last_upto[wd] = last;
      carry = __shfl_sync(kFull, last, 31);
    }
  }
  __syncthreads();

  // 2. speculate: every step from the reset carry of its last alive step
  for (int i0 = 0; i0 < K; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    bool close = false;
    if (i < K) {
      const int wd = i >> 5;
      const unsigned below = alive_bits[wd] & ((1u << (i & 31)) - 1u);
      const int pa = below ? wd * 32 + 31 - __clz(below)
                           : (wd ? last_upto[wd - 1] : -1);
      const bool has = pa >= 0;
      const T dp = has ? ds[row + pa] : T(0);
      const T up = has ? us[row + pa] : T(0);
      const bool al = alive[row + i] != 0;
      const Step<T> o = step(ds[row + i], us[row + i], al, tl, has, dp, up);
      out.put(row + i, i, o, has ? pa : 0, o.close ? 0 : -1);
      close = o.close;
    }
    // a warp's 32 steps are one word of the mask (blockDim.x % 32 == 0)
    const unsigned bits = __ballot_sync(kFull, close);
    if (lane == 0 && i0 + threadIdx.x < K) close_bits[(i0 >> 5) + warp] = bits;
  }
  __syncthreads();

  // 3. resolve: one warp recomputes the steps after each close step
  if (warp != 0) return;
  bool serial = false, has = false;
  long long ip = 0, last_i = -1, last_d = 0;
  T dp = T(0), up = T(0);
  int pos = 0;  // the first step not yet settled
  while (pos < K) {
    if (!serial) {
      // the next speculated close step at or after pos
      int wd = pos >> 5;
      const unsigned first = close_bits[wd] & (kFull << (pos & 31));
      int c = K;
      if (first) {
        c = wd * 32 + __ffs(first) - 1;
      } else {
        for (wd = wd + 1; wd < nw; wd += 32) {
          const unsigned cw = wd + lane < nw ? close_bits[wd + lane] : 0u;
          const unsigned hit = __ballot_sync(kFull, cw != 0u);
          if (hit) {
            const int at = wd + __ffs(hit) - 1;
            c = at * 32 + __ffs(close_bits[at]) - 1;
            break;
          }
        }
      }
      if (c >= K) break;
      // its carry is the reset carry of its partner, the last alive step
      ip = idx[out.plane + row + c];
      dp = ds[row + ip];
      up = us[row + ip];
      has = true;
      last_i = -1;
      last_d = 0;
      serial = true;
      pos = c;
    }
    // recompute from pos on, one step at a time, to the end of its batch
    const int i0 = pos & ~31;
    const int steps = min(32, K - i0);
    T cd = T(0), cu = T(0);
    int ca = 0;
    if (lane < steps) {
      cd = ds[row + i0 + lane];
      cu = us[row + i0 + lane];
      ca = alive[row + i0 + lane];
    }
    Step<T> mine;
    long long m_ip = 0, m_dep = -1;
    bool redo = false;
    int j = pos - i0;
    for (; j < steps; ++j) {  // the same on every lane
      const T di = __shfl_sync(kFull, cd, j);
      const T ui = __shfl_sync(kFull, cu, j);
      const bool al = __shfl_sync(kFull, ca, j) != 0;
      const Step<T> o = step(di, ui, al, tl, has, dp, up);
      const long long i = i0 + j;
      const long long depth = (o.close && ip == last_i) ? last_d + 1 : 0;
      if (lane == j) {
        mine = o;
        m_ip = ip;
        m_dep = o.close ? depth : -1;
        redo = true;
      }
      if (o.close) {
        last_i = i;
        last_d = depth;
      }
      if (al) {
        dp = o.dp;
        up = o.up;
        ip = i;
        has = true;
        if (!o.close) {
          serial = false;
          ++j;
          break;
        }
      }
    }
    if (redo) out.put(row + i0 + lane, i0 + lane, mine, m_ip, m_dep);
    pos = i0 + j;
  }
  if (lane == 0) {
    // no chain open at the end: the carry is the reset carry of the last
    // alive step, or the initial one
    if (!serial) {
      const int last = last_upto[nw - 1];
      has = last >= 0;
      ip = has ? last : 0;
      dp = has ? ds[row + last] : T(0);
      up = has ? us[row + last] : T(0);
    }
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
  const int threads = min(kMaxThreads, (K + 31) / 32 * 32);
  const size_t smem = 3 * sizeof(unsigned) * ((K + 31) / 32);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dc_deflate_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dc_deflate_kernel<T><<<nb, threads, smem,
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
