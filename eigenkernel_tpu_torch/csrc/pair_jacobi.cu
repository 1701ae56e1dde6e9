// Batched symmetric eigh of small blocks by two-sided cyclic Jacobi (D2),
// one CTA a block.
//
// Replaces: the jnp.linalg.eigh of the (m, 2b, 2b) pair blocks in
// eigenkernel_tpu/ops/jacobi.py::block_jacobi_eigh (:94), called once a
// tournament round.  It is not a TPU kernel: the JAX package leaves that
// step to the library eigensolver, and on the card a batched library eigh
// of matrices this wide runs one solver call a matrix.
//
// Computes, for each of the m symmetric w x w blocks of a, its eigenvalues
// (the diagonal left by the rotations, in Jacobi order) and the transposed
// eigenvector matrix V^T, by sweeps of the parallel (round-robin) cyclic
// order: a sweep is W - 1 sets of W / 2 disjoint pairs (p, q), W = w
// rounded up to even, set r being round r of the circle method
// (ops/jacobi.py::pair_sets; a pair with q = w is a bye).  Per pair:
//
//     skip, and set a_pq = a_qp = 0,  if |a_pq| <= eps sqrt(|a_pp a_qq|)
//     tau = (a_qq - a_pp) / (2 a_pq),  t = sign(tau) / (|tau| + sqrt(1 + tau^2))
//     c = 1 / sqrt(1 + t^2),  s = t c          (Rutishauser's form)
//
// then the rows p, q (x_p <- c x_p - s x_q, x_q <- s x_p + c x_q), a
// barrier, the columns (a_pq, a_qp set to exactly 0) and the rows of V^T.
// A block stops after a sweep without a rotation, or after max_sweeps, and
// writes the sweeps it ran and the rotations it applied.
//
// Arithmetic: every product and sum is rounded on its own (__dmul_rn,
// __dadd_rn and the float forms: no contraction into FMAs), and sqrt and
// division are the IEEE ones, so the result equals, bit for bit, the plain
// PyTorch version (ops/jacobi.py::pair_eigh_plain), which evaluates the
// same expressions with one rounding per operation.
//
// What bounds it on the card: the chain.  A sweep is w - 1 dependent sets,
// each a rotation's parameters (two square roots and three divisions in a
// row) and three barriers; the operations of a set, 18 w a rotation over
// w / 2 rotations, are spread over the CTA, and the bytes (the block read
// once, values and vectors written once) are far below the memory rate.
// At w = 128 a set is 64 rotations of 2,304 operations on a resident
// 128 x 128 block; m = 32 blocks fill 32 of the 132 SMs.
//
// What the design does about it: the block stays on the SM.  It lives in
// dynamic shared memory with a row stride of w + 1 (so that a warp walking
// a column hits distinct banks), 130 KB in float64 at w = 128, after the
// opt-in of cudaFuncAttributeMaxDynamicSharedMemorySize; V^T goes there
// too where both fit (float32 at w = 128), else to its output in global
// memory, where a CTA's rows stay in L2 and the rotations touch V^T by
// rows, coalesced.  Where even the block does not fit, it lives in a
// scratch buffer the wrapper passes.  A set's work is split over 512
// threads as (pair, index) items, warps walking consecutive indices.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSmem = 232448;  // opt-in dynamic shared memory, sm_90

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

template <typename T>
__device__ __forceinline__ T machine_eps();
template <>
__device__ __forceinline__ double machine_eps<double>() {
  return DBL_EPSILON;
}
template <>
__device__ __forceinline__ float machine_eps<float>() {
  return FLT_EPSILON;
}

// Shared memory: the set's rotations (c, s of the working type; p, q and a
// flag as ints: 1 rotate, 0 skip, -1 bye) and the running rotation count,
// rounded up to 16 bytes; then A (w rows of stride w + 1) if it fits, then
// V^T (w x w) if that fits too.
struct Layout {
  int hdr, smem, a_res, v_res;
};

__host__ __device__ inline Layout layout(int w, int isz) {
  const int P = (w + 1) / 2;
  Layout L;
  L.hdr = (2 * P * isz + 3 * P * 4 + 4 + 15) & ~15;
  L.smem = L.hdr;
  L.a_res = L.v_res = 0;
  const long long a_bytes = 1LL * w * (w + 1) * isz;
  const long long v_bytes = 1LL * w * w * isz;
  if (L.hdr + a_bytes <= kMaxSmem) {
    L.a_res = 1;
    L.smem += static_cast<int>(a_bytes);
    if (L.smem + v_bytes <= kMaxSmem) {
      L.v_res = 1;
      L.smem += static_cast<int>(v_bytes);
    }
  }
  return L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pair_jacobi_kernel(const T* __restrict__ a, int m, int w, int max_sweeps,
                       T* __restrict__ values, T* __restrict__ vt,
                       int* __restrict__ counts, T* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(w, sizeof(T));
  const int W = w + (w & 1), P = W / 2, S = W - 1;
  const int lda = w + 1;
  T* cs = reinterpret_cast<T*>(smem);
  T* sn = cs + P;
  int* pp = reinterpret_cast<int*>(sn + P);
  int* qq = pp + P;
  int* fl = qq + P;
  int* nrot = fl + P;
  const size_t blk = blockIdx.x;
  T* A = L.a_res ? reinterpret_cast<T*>(smem + L.hdr)
                 : work + blk * w * lda;
  T* V = L.v_res ? A + static_cast<size_t>(w) * lda : vt + blk * w * w;

  const T* ab = a + blk * w * w;
  for (int idx = threadIdx.x; idx < w * w; idx += kThreads) {
    const int r = idx / w, c = idx - r * w;
    A[r * lda + c] = ab[idx];
    V[idx] = r == c ? T(1) : T(0);
  }
  if (threadIdx.x == 0) *nrot = 0;
  __syncthreads();

  const T eps = machine_eps<T>();
  int sweeps = 0, before = 0;
  while (sweeps < max_sweeps) {
    ++sweeps;
    for (int r = 0; r < S; ++r) {
      // the set's rotations, a thread a pair
      for (int i = threadIdx.x; i < P; i += kThreads) {
        const int x = i == 0 ? 0 : 1 + (i - 1 + r) % (W - 1);
        const int y = 1 + (W - 2 - i + r) % (W - 1);
        const int p = min(x, y), q = max(x, y);
        int f = -1;
        if (q < w) {
          const T app = A[p * lda + p], aqq = A[q * lda + q];
          const T apq = A[p * lda + q];
          const T thr = mul(eps, sqrt_rn(fabs(mul(app, aqq))));
          f = 0;
          if (fabs(apq) > thr) {
            const T tau = div(sub(aqq, app), mul(T(2), apq));
            const T sg = tau >= T(0) ? T(1) : T(-1);
            const T t =
                div(sg, add(fabs(tau), sqrt_rn(add(T(1), mul(tau, tau)))));
            const T c = div(T(1), sqrt_rn(add(T(1), mul(t, t))));
            cs[i] = c;
            sn[i] = mul(t, c);
            f = 1;
            atomicAdd(nrot, 1);
          }
        }
        pp[i] = p;
        qq[i] = q;
        fl[i] = f;
      }
      __syncthreads();
      // rows p, q of A
      for (int idx = threadIdx.x; idx < P * w; idx += kThreads) {
        const int i = idx / w, k = idx - i * w;
        if (fl[i] != 1) continue;
        const int p = pp[i], q = qq[i];
        const T c = cs[i], s = sn[i];
        const T xp = A[p * lda + k], xq = A[q * lda + k];
        A[p * lda + k] = sub(mul(c, xp), mul(s, xq));
        A[q * lda + k] = add(mul(s, xp), mul(c, xq));
      }
      __syncthreads();
      // columns p, q of A (a_pq, a_qp exactly 0) and rows p, q of V^T
      for (int idx = threadIdx.x; idx < P * w; idx += kThreads) {
        const int i = idx / w, k = idx - i * w;
        const int f = fl[i];
        if (f < 0) continue;
        const int p = pp[i], q = qq[i];
        if (f == 1) {
          const T c = cs[i], s = sn[i];
          const T xp = A[k * lda + p], xq = A[k * lda + q];
          A[k * lda + p] = k == q ? T(0) : sub(mul(c, xp), mul(s, xq));
          A[k * lda + q] = k == p ? T(0) : add(mul(s, xp), mul(c, xq));
          const T vp = V[p * w + k], vq = V[q * w + k];
          V[p * w + k] = sub(mul(c, vp), mul(s, vq));
          V[q * w + k] = add(mul(s, vp), mul(c, vq));
        } else if (k == p) {
          A[p * lda + q] = T(0);
        } else if (k == q) {
          A[q * lda + p] = T(0);
        }
      }
      __syncthreads();
    }
    // every thread reads the count before any can add to it again
    const int now = *nrot;
    __syncthreads();
    if (now == before) break;
    before = now;
  }

  for (int k = threadIdx.x; k < w; k += kThreads)
    values[blk * w + k] = A[k * lda + k];
  if (L.v_res) {
    T* out = vt + blk * w * w;
    for (int idx = threadIdx.x; idx < w * w; idx += kThreads)
      out[idx] = V[idx];
  }
  if (threadIdx.x == 0) {
    counts[blk] = sweeps;
    counts[m + blk] = *nrot;
  }
}

template <typename T>
int launch(const void* a, int m, int w, int max_sweeps, void* values,
           void* vt, void* counts, void* work, void* stream) {
  if (m < 1 || w < 1 || max_sweeps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = layout(w, sizeof(T));
  if (!L.a_res && work == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      pair_jacobi_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_jacobi_kernel<T><<<m, kThreads, L.smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), m, w, max_sweeps, static_cast<T*>(values),
      static_cast<T*>(vt), static_cast<int*>(counts), static_cast<T*>(work));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: (m, w, w) symmetric blocks, contiguous; values: (m, w); vt: (m, w, w),
// V^T of each block; counts: (2, m) int32, the sweeps and the rotations of
// each block; work: (m, w, w + 1) scratch where the block does not fit in
// shared memory (ek_pair_jacobi_resident bit 0 clear), else unused.
// Returns cudaGetLastError() after the launch.
extern "C" int ek_pair_jacobi_f64(const void* a, int m, int w,
                                  int max_sweeps, void* values, void* vt,
                                  void* counts, void* work, void* stream) {
  return launch<double>(a, m, w, max_sweeps, values, vt, counts, work,
                        stream);
}

extern "C" int ek_pair_jacobi_f32(const void* a, int m, int w,
                                  int max_sweeps, void* values, void* vt,
                                  void* counts, void* work, void* stream) {
  return launch<float>(a, m, w, max_sweeps, values, vt, counts, work,
                       stream);
}

// The dynamic shared memory of a launch at width w, item size isz.
extern "C" int ek_pair_jacobi_smem(int w, int isz) {
  return layout(w, isz).smem;
}

// Bit 0: the block lives in shared memory; bit 1: V^T too.
extern "C" int ek_pair_jacobi_resident(int w, int isz) {
  const Layout L = layout(w, isz);
  return L.a_res | (L.v_res << 1);
}
