// Stage-2 (bulge-chase) eigenvector back-transform z <- Q2 z, straight from
// the chase reflectors HV (n, T, b) / HT (n, T): sweep c holds T disjoint
// reflectors H = I - tau v v^T, window t on rows [c + 1 + t b, c + 1 +
// (t + 1) b), and Q2 z applies the sweeps newest first.
//
// Replaces: eigenkernel_tpu/ops/pallas_backtransform.py::
// apply_chase_q_pallas (Pallas kernel _backtransform_kernel), which pins a
// column tile of z in VMEM and applies one sweep at a time as rank-1
// updates, its reflectors pre-shifted to 8-row alignment and scaled by
// sqrt(tau).  Neither trick carries over (the card has no sublane rule),
// and a whole column tile of z does not fit in shared memory (n = 4096 x
// 8 columns of float64 is 256 KB).
//
// The order is that of ops/bulge.py::apply_chase_q_blocked: g consecutive
// sweeps c0 - g + 1 .. c0 at band position t form one block, a compact-WY
// product P = I - Y T^T Y^T over the (L = b + g - 1)-row window starting at
// row c0 - g + 2 + t b; Y (L x g) holds the reflectors on a shifted
// diagonal, newest sweep in column 0.  Groups go newest first, positions
// ascending inside a group; that keeps every overlapping reflector pair in
// the order of the sweep-by-sweep product (g <= b; the proof is in the JAX
// module), so the result is exactly Q2 z up to rounding.  Blocks whose
// window starts at or past row n hold only zero reflectors and are
// skipped.
//
// Two launches a call:
// * chase_bt_factor, one CTA per (group, position): builds LAPACK dlarft's
//   upper-triangular T of the block with tau as it is (a tau = 0 column of
//   T, and with it its row, is zero, whatever v holds) and writes T^T,
//   gp x (gp + 4) (gp = g rounded up to 16, zero-padded);
// * chase_bt_apply, one CTA per column tile of NC = 4, 8 or 16 columns,
//   walks every block in order.  The window lives in a shared-memory ring
//   of z rows (a power of two >= L + 2 b rows, rows outside z zero): block
//   t and t + 1 of a group share L - b = g - 1 rows, so while block t
//   computes, cp.async brings the next b rows of z, and the copy engine
//   (TMA) the next block's reflector rows (one tiled copy, double-buffered)
//   and, behind the product that reads it, its T^T (one bulk copy).  After
//   block t the first b rows of the window are final for the group and go
//   back to z; at a group's end the whole window does, and the next
//   group's first window is read back.  Per block:
//     W = Y^T z_win (g x NC), W <- -T^T W, z_win += Y W.
//   Y is read off the HV rows (g rows of b at stride T b) on its shifted
//   diagonal, by index, where the products read it.
//
// What bounds it on the card: the function is 4 b k operations per live
// reflector (16.8 GFLOP at n = 4096, k = 500, b = 64: 0.25 ms at the FP64
// tensor-core peak, obs/flops.py::bound_chase_bt); the WY form does
// (2 (2 L g) + g^2) k per block, 1.6x that at g = 32, 2.3x at g = 64.
// Bytes are far below: z is read and written once per group, the
// reflectors once per column tile, from L2.  Each CTA's walk is a chain of
// small dependent products, four barriers a block, so what bounds a CTA is
// the latency of one block, and what bounds the call is blocks x that
// latency (nG * T / 2 blocks, one CTA per SM; PERF.md has the cycles of
// each segment of a block, from tools/chase_bt_profile.py).  The design:
// * g = 64 (the most the kernel takes) halves the blocks of g = 32 for
//   1.4x the operations: the latency a block grows less than the count
//   falls;
// * float64 products on the FP64 tensor cores, mma.sync m16n8k4 (m8n8k4
//   issues at half the rate on sm_90), fragments as in wf_bt.cu; Y^T z is
//   split along its depth so all 8 warps have a tile, the slices summed
//   where the next product reads them; T^T and z pitches == 4 mod 16 words
//   keep their fragment loads free of bank conflicts, v's 8 mod 16 leaves
//   2-way ones (16-byte rows allow no better);
// * float32 (no full-precision tensor-core route) on the CUDA cores, four
//   columns a thread, the depth of each sum split over adjacent lanes;
// * one thread issues a block's reflector copy: threads that copy 32 KB a
//   block (g = b = 64, float64) with cp.async stall on the issue, ~2,800
//   cycles of a ~8,000-cycle block, and a bulk copy a row costs the copy
//   engine more than that; the tiled copy also zero-fills sweeps before 0
//   and the row padding.  Copies of z are 16 bytes where k and the base
//   allow, else one element.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFactorThreads = 128;
constexpr int kSmemMax = 232448;          // a block's shared memory on sm_90

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Depth slices of the float64 product Y^T z: enough for its 16 x 8 tiles
// (a 4-column tile pads to 8) to occupy every warp.
__host__ __device__ constexpr int split_of(int itemsize, int gp, int nc) {
  return itemsize != 8 || (gp / 16) * (nc < 8 ? 1 : nc / 8) >= kWarps
             ? 1
             : kWarps / ((gp / 16) * (nc < 8 ? 1 : nc / 8));
}

// The apply kernel's shared-memory layout (ops/backtransform.py::
// smem_bytes computes the same): kBarBytes of mbarriers, then, in words,
// two buffers of a block's gp reflector rows (gp, pv), T^T (gp, gp + 4),
// the z ring (ring, sz), `split` slices of Y^T z and the scaled product
// (gp, sz each).  float64 rows of v have a pitch of 8 mod 16 words, which
// keeps the fragment loads of v to 2-way bank conflicts; any pitch that
// keeps rows 16-byte aligned has some.
constexpr int kBarBytes = 128;   // keeps the v buffers 128-byte aligned

struct Geom {
  int gp, L, Lr, Lk, pv, sz, ring, split, words;
  __host__ __device__ Geom(int itemsize, int b, int g, int nc) {
    gp = round_up(g, 16);
    L = b + g - 1;
    Lr = round_up(L, 16);
    Lk = round_up(L, 4);
    pv = itemsize == 8 ? round_up(b, 16) + 8 : round_up(b, 4);
    sz = (nc < 8 ? 8 : nc) + 4;
    ring = 1;
    while (ring < L + 2 * b) ring *= 2;
    split = split_of(itemsize, gp, nc);
    words = 2 * gp * pv + gp * (gp + 4) + (ring + (split + 1) * gp) * sz;
  }
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy kBytes from global src to shared dst, or zero-fill dst when !ok.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  const int src_bytes = ok ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(kBytes), "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// The copy engine (TMA) reports the bytes it has written to an mbarrier,
// whose phase completes once its one arrival (mbar_expect, which announces
// the bytes) and all the bytes are in.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// A bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global src to shared dst.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The copy engine's tiled copy of the box of `map` at (x, y, w) (innermost
// first) to shared dst (128-byte aligned); coordinates outside the tensor
// read as zeros.  Reports the box's bytes to bar.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int x, int y, int w,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(w),
      "r"(smem_u32(bar))
      : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// m16n8k4 DMMA (g = lane / 4, t = lane % 4): A (16 x 4) a0 = A[g][t],
// a1 = A[g + 8][t]; B (4 x 8) b = B[t][g]; C (16 x 8) c0, c1 = C[g][2t],
// C[g][2t + 1], c2, c3 the same in row g + 8.
__device__ __forceinline__ void dmma(double (&c)[4], double a0, double a1,
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// ---- the factors -----------------------------------------------------------

// CTA (G, t): T of block (G, t), the upper-triangular factor of dlarft,
// as T = (I + D S)^{-1} D with D = diag(tau) and S the strictly upper Gram
// matrix, S[i][j] = Y[:, i]^T Y[:, j] = sum_q v_i[q] v_j[q + j - i] read
// off the raw reflectors (T^{-1} = D^{-1} + S where every tau != 0; this
// form also holds at tau = 0).  Its columns are independent: thread c
// solves column c, T[c][c] = tau_c, T[i][c] = -tau_i sum_{l = i+1..c}
// S[i][l] T[l][c] for i = c - 1 down to 0, with no barrier between rows.
// Writes T^T to tf[G, t] (gp x (gp + 4), the pitch of the apply kernel's
// copy).
template <typename T>
__global__ void __launch_bounds__(kFactorThreads)
    chase_bt_factor(const T* __restrict__ hv, const T* __restrict__ ht,
                    T* __restrict__ tf, int n, int nt, int b, int g,
                    int gp) {
  const int G = blockIdx.x, t = blockIdx.y;
  const int c0 = n - 3 - G * g;
  if (c0 - g + 2 + t * b >= n) return;      // a dead block: never applied
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // pitches b + 1 and g + 1: the threads of a warp read a column of each
  const int pb = b + 1, pg = g + 1;
  T* v = reinterpret_cast<T*>(smem_raw);     // (g, pb): v of sweep c0 - j
  T* tau = v + g * pb;                       // (g,)
  T* gram = tau + g;                         // (g, pg), strictly upper
  T* tm = gram + g * pg;                     // (g, pg): T
  for (int e = threadIdx.x; e < g * b; e += blockDim.x) {
    const int j = e / b, q = e - j * b, c = c0 - j;
    v[j * pb + q] =
        c >= 0 ? hv[(static_cast<size_t>(c) * nt + t) * b + q] : T(0);
  }
  for (int j = threadIdx.x; j < g; j += blockDim.x)
    tau[j] = c0 - j >= 0 ? ht[static_cast<size_t>(c0 - j) * nt + t] : T(0);
  __syncthreads();
  for (int p = threadIdx.x; p < g * g; p += blockDim.x) {
    const int i = p / g, j = p - i * g, d = j - i;
    T s = T(0);
    if (d > 0)
      for (int q = 0; q < b - d; ++q) s += v[i * pb + q] * v[j * pb + q + d];
    gram[i * pg + j] = s;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < g; c += blockDim.x) {
    tm[c * pg + c] = tau[c];
    for (int i = c - 1; i >= 0; --i) {
      T s0 = T(0), s1 = T(0);
      int l = i + 1;
      for (; l < c; l += 2) {
        s0 += gram[i * pg + l] * tm[l * pg + c];
        s1 += gram[i * pg + l + 1] * tm[(l + 1) * pg + c];
      }
      if (l == c) s0 += gram[i * pg + l] * tm[l * pg + c];
      tm[i * pg + c] = -tau[i] * (s0 + s1);
    }
  }
  __syncthreads();
  const int st = gp + 4;
  T* out = tf + (static_cast<size_t>(G) * nt + t) * gp * st;
  for (int p = threadIdx.x; p < gp * st; p += blockDim.x) {
    const int i = p / st, l = p - i * st;
    out[p] = (i < g && l <= i) ? tm[l * pg + i] : T(0);
  }
}

// ---- the walk over the blocks ---------------------------------------------

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

// Sum acc over the S adjacent lanes of a group (S a power of two <= 32;
// every lane of the warp takes part).
template <int S>
__device__ __forceinline__ void reduce4(float4& acc) {
#pragma unroll
  for (int o = 1; o < S; o <<= 1) {
    acc.x += __shfl_xor_sync(0xffffffffu, acc.x, o);
    acc.y += __shfl_xor_sync(0xffffffffu, acc.y, o);
    acc.z += __shfl_xor_sync(0xffffffffu, acc.z, o);
    acc.w += __shfl_xor_sync(0xffffffffu, acc.w, o);
  }
}

// Rows [r0, r0 + rows) of z's column tile [col0, col0 + NC) into the ring
// (zeros outside z), V elements a copy.
template <typename T, int NC, int V>
__device__ __forceinline__ void load_rows(T* zr, int sz, int mask,
                                          const T* z, int n, int k,
                                          int col0, int r0, int rows) {
  constexpr int cpr = NC / V;
  for (int e = threadIdx.x; e < rows * cpr; e += kThreads) {
    const int r = e / cpr, c = (e - r * cpr) * V, row = r0 + r;
    const bool ok = row >= 0 && row < n && col0 + c < k;
    cp_async<V * static_cast<int>(sizeof(T))>(
        zr + (row & mask) * sz + c,
        ok ? z + static_cast<size_t>(row) * k + col0 + c : z, ok);
  }
}

// Ring rows [r0, r0 + rows) back to z (inside z only), V elements a store.
template <typename T, int NC, int V>
__device__ __forceinline__ void store_rows(const T* zr, int sz, int mask,
                                           T* z, int n, int k, int col0,
                                           int r0, int rows) {
  constexpr int cpr = NC / V;
  for (int e = threadIdx.x; e < rows * cpr; e += kThreads) {
    const int r = e / cpr, c = (e - r * cpr) * V, row = r0 + r;
    if (row < 0 || row >= n || col0 + c >= k) continue;
    const T* s = zr + (row & mask) * sz + c;
    T* d = z + static_cast<size_t>(row) * k + col0 + c;
    if constexpr (V * sizeof(T) == 16) {
      *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(s);
    } else if constexpr (V * sizeof(T) == 8) {
      *reinterpret_cast<float2*>(d) = *reinterpret_cast<const float2*>(s);
    } else {
      *d = *s;
    }
  }
}

// One CTA per column tile of NC columns walks every block (module note).
// GP = g rounded up to 16.  The reflector rows of a block stay as the chase
// wrote them, oldest sweep first: buffer row GP - 1 - j holds v_j, sweep
// c0 - j; Y^T[j][r] = v_j[r - (g - 1 - j)] where that index lies in [0, b),
// else 0, is read off them with that predicate.  Rows j >= g hold older
// sweeps' reflectors or zeros, which meet only zero rows and columns of
// T^T.  vec: bit 0, z's rows allow 16-byte copies; bit 1, HV's rows do (b
// a multiple of 16 bytes, HV's base aligned, pv <= 256): then the copy
// engine brings a block's GP rows in one tiled copy of vmap, HV as a
// (n, T, b) tensor with boxes of (GP, 1, pv) (columns past b and sweeps
// before 0 read as zeros), else the threads do, an element a copy.
template <typename T, int GP, int NC>
__global__ void __launch_bounds__(kThreads, 1)
    chase_bt_apply(const T* __restrict__ hv, const T* __restrict__ tf,
                   T* __restrict__ z, int n, int k, int nt, int b, int g,
                   int vec, const __grid_constant__ CUtensorMap vmap) {
  constexpr bool kF64 = sizeof(T) == 8;
  constexpr int V16 = 16 / static_cast<int>(sizeof(T));
  constexpr int VZ = NC < V16 ? NC : V16;   // elements a 16-byte z copy
  constexpr int NT = NC < 8 ? 1 : NC / 8;   // 8-column DMMA tiles
  constexpr int MT = GP / 16;               // 16-row tiles of W
  constexpr int SPLIT = split_of(sizeof(T), GP, NC);
  constexpr int STT = GP + 4;
  constexpr int SZ = (NC < 8 ? 8 : NC) + 4;
  const Geom geo(sizeof(T), b, g, NC);
  const int L = geo.L, pv = geo.pv, mask = geo.ring - 1;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // mbarriers: the two v buffers', then T^T's
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem_raw);
  T* const ys = reinterpret_cast<T*>(smem_raw + kBarBytes);  // 2 x (GP, pv)
  T* const tt = ys + 2 * GP * pv;                 // (GP, STT): T^T
  T* const zr = tt + GP * STT;                    // (ring, SZ): z rows
  T* const wp = zr + geo.ring * SZ;               // SPLIT x (GP, SZ): Y^T z
  T* const w2 = wp + SPLIT * GP * SZ;             // (GP, SZ): -T^T Y^T z
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, fr = lane >> 2, fk = lane & 3;
  const int col0 = blockIdx.x * NC;

  // zeros once: the ring's rows outside z and its columns past NC are
  // never written, nor rows j >= g of the v buffers where the threads copy
  // them; the fence orders these stores before the copy engine's writes
  for (int i = tid; i < geo.words; i += kThreads) ys[i] = T(0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the reflector rows of block (cn, tp) into buffer bi (zeros for
  // sweeps before 0, which only the last group has)
  const bool bulk_v = (vec & 2) != 0;
  const CUtensorMap* const vmap_p = &vmap;
  auto load_v = [&](int bi, int cn, int tp) {
    T* dst = ys + bi * GP * pv;
    if (bulk_v) {
      if (tid == 0) {
        mbar_expect(bars + bi, GP * pv * sizeof(T));
        tma_load_3d(dst, vmap_p, 0, tp, cn - GP + 1, bars + bi);
      }
      return;
    }
    const int live = min(g, cn + 1);
    for (int e = tid; e < live * b; e += kThreads) {
      const int j = e / b, q = e - j * b;
      cp_async<static_cast<int>(sizeof(T))>(
          dst + (GP - 1 - j) * pv + q,
          hv + (static_cast<size_t>(cn - j) * nt + tp) * b + q, true);
    }
    for (int e = tid; e < (g - live) * b; e += kThreads) {
      const int j = live + e / b;
      dst[(GP - 1 - j) * pv + e - (j - live) * b] = T(0);
    }
  };
  // T^T of block (gi, tp), one bulk copy (the factor kernel wrote it at
  // this pitch)
  auto load_t = [&](int gi, int tp) {
    if (tid == 0) {
      constexpr unsigned kBytes = GP * STT * sizeof(T);
      mbar_expect(bars + 2, kBytes);
      bulk_copy(tt, tf + (static_cast<size_t>(gi) * nt + tp) * GP * STT,
                kBytes, bars + 2);
    }
  };
  auto load_z = [&](int r0, int rows) {
    if (vec & 1)
      load_rows<T, NC, VZ>(zr, SZ, mask, z, n, k, col0, r0, rows);
    else
      load_rows<T, NC, 1>(zr, SZ, mask, z, n, k, col0, r0, rows);
  };
  auto store = [&](int r0, int rows) {
    if (vec & 1)
      store_rows<T, NC, VZ>(zr, SZ, mask, z, n, k, col0, r0, rows);
    else
      store_rows<T, NC, 1>(zr, SZ, mask, z, n, k, col0, r0, rows);
  };
  auto span = [&](int gi, int& cn, int& bn, int& cnt) {
    cn = n - 3 - gi * g;
    bn = cn - g + 2;
    cnt = (n - bn + b - 1) / b;
    if (cnt > nt) cnt = nt;
  };

  const int nG = (n - 2 + g - 1) / g;
  int G = 0, t = 0, c0, base, count;
  span(0, c0, base, count);
  load_v(0, c0, 0);
  load_z(base, L);
  cp_async_commit();
  load_t(0, 0);
  int done_row = 0;         // rows [done_row, + b) are final: store them
  bool pending = false;
  unsigned vphase = 0, tphase = 0;   // the parity each barrier waits for
  for (int it = 0; G < nG; ++it) {
    const int buf = it & 1;
    const T* yb = ys + buf * GP * pv;
    const int row0 = base + t * b;
    int Gn = G, tn = t + 1, c0n = c0, basen = base, countn = count;
    if (tn >= count) {
      Gn = G + 1;
      tn = 0;
      if (Gn < nG) span(Gn, c0n, basen, countn);
    }
    const bool has_next = Gn < nG, same = Gn == G;
    // this block's z rows and reflectors have landed (its T^T may still
    // fly)
    cp_async_wait<0>();
    if (bulk_v) {
      mbar_wait(bars + buf, (vphase >> buf) & 1u);
      vphase ^= 1u << buf;
    }
    __syncthreads();
    // the previous block's first b rows, while this one computes: the
    // loads below go to ring rows at least L + 2b past them
    if (pending) store(done_row, b);
    if (has_next) {
      load_v(buf ^ 1, c0n, tn);
      if (same) load_z(row0 + L, b);
    }
    cp_async_commit();

    // W = Y^T z_win: row m of Y^T is nonzero on window rows [g - 1 - m,
    // g - 1 - m + b), so a 16-row tile needs b + 16 of them
    if constexpr (kF64) {
      for (int task = warp; task < MT * NT * SPLIT; task += kWarps) {
        const int s = task % SPLIT, tile = task / SPLIT;
        const int mi = tile % MT, ni = tile / MT, m0 = mi * 16;
        const int klo = max(0, g - 16 - m0) & ~3;
        const int khi = min(geo.Lk, round_up(g - 1 - m0 + b, 4));
        const int per = (max(0, khi - klo) / 4 + SPLIT - 1) / SPLIT * 4;
        const int k0 = klo + s * per, k1 = min(khi, k0 + per);
        const int ma = m0 + fr, mb = ma + 8;
        const int sa = g - 1 - ma, sb = g - 1 - mb;    // shifts of rows
        const T* va = yb + (GP - 1 - ma) * pv;
        const T* vb = yb + (GP - 1 - mb) * pv;
        const T* pz = zr + ni * 8 + fr;
        double acc0[4] = {0.0, 0.0, 0.0, 0.0}, acc1[4] = {0.0, 0.0, 0.0, 0.0};
        for (int kk = k0; kk < k1; kk += 8) {
          {
            const int r = kk + fk, qa = r - sa, qb = r - sb;
            const double a0 = qa >= 0 && qa < b ? va[qa] : 0.0;
            const double a1 = qb >= 0 && qb < b ? vb[qb] : 0.0;
            const double bz = r < L ? pz[((row0 + r) & mask) * SZ] : 0.0;
            dmma(acc0, a0, a1, bz);
          }
          if (kk + 4 < k1) {
            const int r = kk + 4 + fk, qa = r - sa, qb = r - sb;
            const double a0 = qa >= 0 && qa < b ? va[qa] : 0.0;
            const double a1 = qb >= 0 && qb < b ? vb[qb] : 0.0;
            const double bz = r < L ? pz[((row0 + r) & mask) * SZ] : 0.0;
            dmma(acc1, a0, a1, bz);
          }
        }
        double* w = wp + s * GP * SZ + ma * SZ + ni * 8 + 2 * fk;
        w[0] = acc0[0] + acc1[0];
        w[1] = acc0[1] + acc1[1];
        w[8 * SZ] = acc0[2] + acc1[2];
        w[8 * SZ + 1] = acc0[3] + acc1[3];
      }
    } else {
      // a thread sums four columns of one row of W over every S1-th
      // nonzero of its Y^T row (S1 adjacent lanes, then shuffles)
      constexpr int NQ = NC / 4;
      constexpr int S1 = GP * NQ >= kThreads ? 1 : kThreads / (GP * NQ);
      for (int e = tid; e < GP * NQ * S1; e += kThreads) {
        const int u = e / S1, sl = e - u * S1, i = u / NQ;
        const int cq = (u - i * NQ) * 4;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < g) {
          const T* v = yb + (GP - 1 - i) * pv;
          const int rz = row0 + g - 1 - i;
          for (int q = sl; q < b; q += S1)
            fma4(acc, v[q], *reinterpret_cast<const float4*>(
                                zr + ((rz + q) & mask) * SZ + cq));
        }
        reduce4<S1>(acc);
        if (sl == 0) *reinterpret_cast<float4*>(wp + i * SZ + cq) = acc;
      }
    }
    mbar_wait(bars + 2, tphase);   // T^T of this block
    tphase ^= 1u;
    __syncthreads();

    // W <- -T^T W (T^T lower triangular: tile mi needs depth 16 (mi + 1))
    if constexpr (kF64) {
      for (int tile = warp; tile < MT * NT; tile += kWarps) {
        const int mi = tile % MT, ni = tile / MT;
        const T* pa = tt + (mi * 16 + fr) * STT + fk;
        const T* pw = wp + fk * SZ + ni * 8 + fr;
        double acc0[4] = {0.0, 0.0, 0.0, 0.0}, acc1[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
        for (int kk = 0; kk < GP; kk += 4) {
          if (kk < 16 * (mi + 1)) {
            double bw = 0.0;
#pragma unroll
            for (int sl = 0; sl < SPLIT; ++sl) bw += pw[sl * GP * SZ + kk * SZ];
            if ((kk / 4) & 1)
              dmma(acc1, pa[kk], pa[kk + 8 * STT], bw);
            else
              dmma(acc0, pa[kk], pa[kk + 8 * STT], bw);
          }
        }
        double* w = w2 + (mi * 16 + fr) * SZ + ni * 8 + 2 * fk;
        w[0] = -(acc0[0] + acc1[0]);
        w[1] = -(acc0[1] + acc1[1]);
        w[8 * SZ] = -(acc0[2] + acc1[2]);
        w[8 * SZ + 1] = -(acc0[3] + acc1[3]);
      }
    } else {
      constexpr int NQ = NC / 4;
      constexpr int S2 = GP * NQ >= kThreads ? 1 : kThreads / (GP * NQ);
      for (int e = tid; e < GP * NQ * S2; e += kThreads) {
        const int u = e / S2, sl = e - u * S2, i = u / NQ;
        const int cq = (u - i * NQ) * 4;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < g)
          for (int l = sl; l <= i; l += S2)
            fma4(acc, tt[i * STT + l],
                 *reinterpret_cast<const float4*>(wp + l * SZ + cq));
        reduce4<S2>(acc);
        if (sl == 0)
          *reinterpret_cast<float4*>(w2 + i * SZ + cq) =
              make_float4(-acc.x, -acc.y, -acc.z, -acc.w);
      }
    }
    __syncthreads();
    if (has_next) load_t(Gn, tn);

    // z_win += Y W, Y[r][j] = v_j[r - (g - 1 - j)] (rows < L: the ring
    // rows past the window are the next block's, in flight)
    if constexpr (kF64) {
      const int mt = geo.Lr / 16;
      for (int tile = warp; tile < mt * NT; tile += kWarps) {
        const int mi = tile % mt, ni = tile / mt;
        const int ra = mi * 16 + fr, rb = ra + 8;
        double* za = zr + ((row0 + ra) & mask) * SZ + ni * 8 + 2 * fk;
        double* zb = zr + ((row0 + rb) & mask) * SZ + ni * 8 + 2 * fk;
        double acc0[4] = {za[0], za[1], zb[0], zb[1]};
        double acc1[4] = {0.0, 0.0, 0.0, 0.0};
        const int qa0 = ra - (g - 1), qb0 = rb - (g - 1);
        const T* pw = w2 + fk * SZ + ni * 8 + fr;
#pragma unroll
        for (int kk = 0; kk < GP; kk += 4) {
          const int j = kk + fk, qa = qa0 + j, qb = qb0 + j;
          const T* v = yb + (GP - 1 - j) * pv;
          const double a0 = qa >= 0 && qa < b ? v[qa] : 0.0;
          const double a1 = qb >= 0 && qb < b ? v[qb] : 0.0;
          if ((kk / 4) & 1)
            dmma(acc1, a0, a1, pw[kk * SZ]);
          else
            dmma(acc0, a0, a1, pw[kk * SZ]);
        }
        if (ra < L) {
          za[0] = acc0[0] + acc1[0];
          za[1] = acc0[1] + acc1[1];
        }
        if (rb < L) {
          zb[0] = acc0[2] + acc1[2];
          zb[1] = acc0[3] + acc1[3];
        }
      }
    } else {
      // a thread sums four columns of one window row over every S3-th
      // nonzero of its Y row, [g - 1 - r, g - 1 - r + b); the loop runs
      // whole warps so that every lane takes part in the shuffles
      constexpr int NQ = NC / 4, S3 = NQ == 1 ? 2 : 1;
      const int units = L * NQ * S3;
      for (int e = tid; e < round_up(units, 32); e += kThreads) {
        const int u = e / S3, sl = e - u * S3, r = u / NQ;
        const int cq = (u - r * NQ) * 4;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        if (e < units) {
          const int j0 = max(0, g - 1 - r), j1 = min(g, g - 1 - r + b);
          // v_j[r - (g - 1 - j)] at -j (pv - 1)
          const T* v = yb + (GP - 1) * pv + r - (g - 1);
          for (int j = j0 + sl; j < j1; j += S3)
            fma4(acc, v[-j * (pv - 1)],
                 *reinterpret_cast<const float4*>(w2 + j * SZ + cq));
        }
        reduce4<S3>(acc);
        if (sl == 0 && e < units) {
          float4* zq = reinterpret_cast<float4*>(zr + ((row0 + r) & mask) * SZ +
                                                 cq);
          const float4 old = *zq;
          *zq = make_float4(old.x + acc.x, old.y + acc.y, old.z + acc.z,
                            old.w + acc.w);
        }
      }
    }
    if (same) {
      pending = true;       // stored after the next block's first barrier
      done_row = row0;
    } else {
      // the group's end: its whole window goes back, and the next group's
      // first window, which overlaps it, is read after that
      __syncthreads();
      store(row0, L);
      pending = false;
      if (has_next) {
        __threadfence_block();
        __syncthreads();
        load_z(basen, L);
        cp_async_commit();
      }
    }
    G = Gn;
    t = tn;
    c0 = c0n;
    base = basen;
    count = countn;
  }
  cp_async_wait<0>();
}

// ---- host ------------------------------------------------------------------

using ApplyFn = void (*)(const void*, const void*, void*, int, int, int, int,
                         int, int, CUtensorMap);

template <typename Kern>
ApplyFn as_fn(Kern kern) {
  return reinterpret_cast<ApplyFn>(kern);
}

template <typename T, int GP>
ApplyFn pick_nc(int nc) {
  switch (nc) {
    case 4: return as_fn(chase_bt_apply<T, GP, 4>);
    case 8: return as_fn(chase_bt_apply<T, GP, 8>);
    case 16: return as_fn(chase_bt_apply<T, GP, 16>);
    default: return nullptr;
  }
}

template <typename T>
ApplyFn pick(int gp, int nc) {
  switch (gp) {
    case 16: return pick_nc<T, 16>(nc);
    case 32: return pick_nc<T, 32>(nc);
    case 64: return pick_nc<T, 64>(nc);
    default: return nullptr;
  }
}

// HV (n, nt, b) as a tensor of the copy engine with boxes of (gp, 1, pv),
// encoded through the runtime's entry-point query (no link to libcuda);
// false where there is no such entry point or the map is refused.
template <typename T>
bool reflector_map(CUtensorMap* map, const void* hv, int n, int nt, int b,
                   int gp, int pv) {
  using Encode = decltype(&cuTensorMapEncodeTiled);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn,
                                         12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess || fn == nullptr)
      return false;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(b),
                              static_cast<cuuint64_t>(nt),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[2] = {b * sizeof(T),
                                 static_cast<cuuint64_t>(nt) * b * sizeof(T)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(pv), 1,
                             static_cast<cuuint32_t>(gp)};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map,
                sizeof(T) == 8 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64
                               : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                3, const_cast<void*>(hv), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int launch(const void* hv, const void* ht, void* tf, void* z, int n, int k,
           int nt, int b, int g, int nc, void* stream) {
  if (g < 1 || g > b || nt < 1 || nt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom geo(sizeof(T), b, g, nc);
  const ApplyFn fn = pick<T>(geo.gp, nc);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int vec = (k * sizeof(T) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(z) % 16 == 0) |
            (b * sizeof(T) % 16 == 0 && geo.pv <= 256 &&
             reinterpret_cast<uintptr_t>(hv) % 16 == 0) << 1;
  CUtensorMap vmap{};
  if ((vec & 2) &&
      !reflector_map<T>(&vmap, hv, n, nt, b, geo.gp, geo.pv))
    return static_cast<int>(cudaErrorNotSupported);
  const size_t smem = static_cast<size_t>(geo.words) * sizeof(T) + kBarBytes;
  const size_t fsmem =
      static_cast<size_t>(g * (b + 1) + g + 2 * g * (g + 1)) * sizeof(T);
  if (smem > kSmemMax || fsmem > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nG = (n - 2 + g - 1) / g;
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(chase_bt_factor<T>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(fsmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  chase_bt_factor<T><<<dim3(nG, nt), kFactorThreads, fsmem, st>>>(
      static_cast<const T*>(hv), static_cast<const T*>(ht),
      static_cast<T*>(tf), n, nt, b, g, geo.gp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&hv, &tf, &z, &n, &k, &nt, &b, &g, &vec, &vmap};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(fn),
                         dim3((k + nc - 1) / nc), dim3(kThreads), args, smem,
                         st);
  return static_cast<int>(err);
}

}  // namespace

// hv (n, nt, b), ht (n, nt) chase reflectors; tf scratch of
// ceil((n - 2) / g) * nt * gp * (gp + 4) words (gp = g rounded up to 16);
// z (n, k) row-major, updated in place; g <= min(b, 64) sweeps a block, nc
// in {4, 8, 16} columns a CTA.  Two launches; returns the first CUDA error,
// else 0.
extern "C" int ek_chase_bt_f64(const void* hv, const void* ht, void* tf,
                               void* z, int n, int k, int nt, int b, int g,
                               int nc, void* stream) {
  return launch<double>(hv, ht, tf, z, n, k, nt, b, g, nc, stream);
}

extern "C" int ek_chase_bt_f32(const void* hv, const void* ht, void* tf,
                               void* z, int n, int k, int nt, int b, int g,
                               int nc, void* stream) {
  return launch<float>(hv, ht, tf, z, n, k, nt, b, g, nc, stream);
}

// Shared-memory bytes of the apply kernel (ops/backtransform.py::
// smem_bytes must agree).
extern "C" int ek_chase_bt_smem(int itemsize, int b, int g, int nc) {
  return Geom(itemsize, b, g, nc).words * itemsize + kBarBytes;
}
