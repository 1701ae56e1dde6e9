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
// m >= 1 run, for S2 up to about a thousand rows (the z tile below must
// fit in shared memory; the launch fails with cudaErrorInvalidValue past
// that).
//
// One launch per composite step u with live lanes.  The window of lane G
// starts at frame row row0 = (n - 1 - g) - G S2 + m b u + top; windows of
// one u are S2 rows apart, so they are disjoint and the CTAs of a launch
// never touch the same element.
//
// Live lanes (the host loop below, as pallas_wf_bt.py bounds its lane
// loop): G <= u, u - G < Tm, and the window starts above the end of z,
// G >= floor((m b u + K - n) / S2) + 1 with K = n - 1 - g.  Every other
// (u, G) slot of the P stream holds garbage and is never read.
//
// What bounds it on the card: arithmetic, 2 S2^2 flops per element of z
// per live lane (543 GFLOP at n = 16384, k = 500, b = g = 64: 8.1 ms at
// 67 TFLOP/s, the FP64 tensor-core and the FP32 CUDA-core peak); P and z
// are 4.4 GB read once and written once, 1.3 ms at 3.35 TB/s.  One launch
// per step moves every live window of z in and out of device memory at
// every step, though (17.6 MB a launch at n = 16384, k = 500), which is
// what keeps it from that bound.  The design:
// * resident branch (S2 <= 128, the default plans): one CTA per (live
//   lane, column split); the CTA keeps the lane's whole P in shared memory
//   (loaded in four depth quarters, so the first tile computes as they
//   land) and walks its split's z tiles (32 columns in float64, 128 in
//   float32), double-buffered with cp.async; the host picks the splits so
//   that lanes x splits fill the SMs;
// * streamed branch (larger S2): one CTA per (live lane, tile of NC
//   columns) stages its whole S2 x NC window of z, and P streams through
//   shared memory in depth slices, double-buffered;
// * either way a CTA's outputs go straight back in place (its window of z
//   is in shared memory), copies are 16 bytes where the row stride and
//   base allow, else one element, and the S2 and k edges are zero-filled;
// * float64 multiplies on the FP64 tensor cores, mma.sync m16n8k4 (DMMA;
//   m8n8k4 issues at half the rate on sm_90): 8 warps as 4 x 2, a warp
//   tile of 32 rows x 8 WN columns; padded shared-memory pitches keep both
//   fragment loads free of bank conflicts;
// * float32 has no tensor-core route at full precision (wgmma takes no
//   fp32 operands, TF32 keeps 10 bits), so it runs outer products on the
//   CUDA cores, 8 x 8 outputs in registers per thread, P values broadcast
//   from shared memory and z read as float4.
// A z tile kept across composite steps (as the Pallas kernel keeps it in
// VMEM) does not fit: one float64 column of z at n = 16384 is 128 KB.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemMax = 232448;          // a block's shared memory on sm_90

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

// cp_async_wait for a count known at run time, 0 to 4
__device__ __forceinline__ void cp_async_wait_n(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    default: cp_async_wait<4>(); break;
  }
}

// Stage the rows x cols tile at src (row stride ld) into dst (row pitch
// sp) with copies of V elements; elements at row >= rmax or col >= cmax
// are zero.  With V > 1, cols, cmax, ld and src are multiples of V.
template <typename T, int V>
__device__ __forceinline__ void stage(T* dst, int sp, const T* src,
                                      size_t ld, int rows, int cols,
                                      int rmax, int cmax) {
  const int cpr = cols / V;
  for (int idx = threadIdx.x; idx < rows * cpr; idx += kThreads) {
    const int r = idx / cpr, c = (idx - r * cpr) * V;
    const bool ok = r < rmax && c < cmax;
    cp_async<static_cast<int>(V * sizeof(T))>(dst + r * sp + c,
                            ok ? src + r * ld + c : src, ok);
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ void stage_v(T* dst, int sp, const T* src,
                                        size_t ld, int rows, int cols,
                                        int rmax, int cmax) {
  if constexpr (kVec)
    stage<T, static_cast<int>(16 / sizeof(T))>(dst, sp, src, ld, rows, cols,
                                               rmax, cmax);
  else
    stage<T, 1>(dst, sp, src, ld, rows, cols, rmax, cmax);
}

// ---- float64: DMMA -------------------------------------------------------

constexpr int kBM64 = 128;                // output rows per pass
constexpr int kBK64 = 8;                  // P depth per slice
constexpr int kSA64 = kBK64 + 4;          // P slice pitch (bank spread)

// m16n8k4 DMMA (g = lane / 4, t = lane % 4): A (16 x 4) a0 = A[g][t],
// a1 = A[g + 8][t]; B (4 x 8) b = B[t][g]; C (16 x 8) c0, c1 = C[g][2t],
// C[g][2t + 1], c2, c3 the same in row g + 8.  (m8n8k4 runs at half the
// rate on sm_90.)
__device__ __forceinline__ void dmma(double (&c)[4], double a0, double a1,
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// One depth step of 4 of a warp's 32 x 8 WN tile: pa points at A[g][t] of
// the warp's rows (pitch sa), zb at B[t][g] of its columns (pitch sz).
template <int WN>
__device__ __forceinline__ void warp_k4(double (&acc)[2][WN][4],
                                        const double* pa, int sa,
                                        const double* zb) {
  double a[2][2], b[WN];
#pragma unroll
  for (int ti = 0; ti < 2; ++ti) {
    a[ti][0] = pa[ti * 16 * sa];
    a[ti][1] = pa[(ti * 16 + 8) * sa];
  }
#pragma unroll
  for (int tj = 0; tj < WN; ++tj) b[tj] = zb[tj * 8];
#pragma unroll
  for (int ti = 0; ti < 2; ++ti)
#pragma unroll
    for (int tj = 0; tj < WN; ++tj) dmma(acc[ti][tj], a[ti][0], a[ti][1], b[tj]);
}

// Write a warp's tile to z (row stride ld): rows i0 + 8 h + 16 ti (< s2),
// columns c0 + 8 tj + 2 t + e (< cmax).  kPair: a thread's two columns go
// as one 16-byte store (ld, c0 and z's base even; cmax even or past the
// tile).
template <int WN, bool kPair>
__device__ __forceinline__ void warp_store(const double (&acc)[2][WN][4],
                                           double* z, size_t ld, int i0,
                                           int s2, int c0, int cmax, int t) {
#pragma unroll
  for (int ti = 0; ti < 2; ++ti)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + ti * 16 + h * 8;
      if (i >= s2) continue;
#pragma unroll
      for (int tj = 0; tj < WN; ++tj) {
        const int c = c0 + tj * 8 + 2 * t;
        if constexpr (kPair) {
          if (c < cmax)
            *reinterpret_cast<double2*>(z + i * ld + c) =
                make_double2(acc[ti][tj][2 * h], acc[ti][tj][2 * h + 1]);
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (c + e < cmax) z[i * ld + c + e] = acc[ti][tj][2 * h + e];
        }
      }
    }
}

// NC = 16 WN columns per CTA; z pitch NC + 4 (== 4 mod 16 doubles) puts
// the 16 words of each half-warp of a B fragment on distinct banks.
template <bool kVecP, bool kVecZ, int WN>
__global__ void __launch_bounds__(kThreads)
    wf_bt_f64_kernel(const double* __restrict__ p_u, double* __restrict__ zp,
                     int k, int s2, int row_base, int g_lo) {
  constexpr int NC = 16 * WN, SZ = NC + 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int s2r = (s2 + kBK64 - 1) / kBK64 * kBK64;
  double* zs = reinterpret_cast<double*>(smem_raw);      // (s2r, SZ)
  double* ps = zs + static_cast<size_t>(s2r) * SZ;       // 2 x (kBM64, kSA64)

  const int lane_g = g_lo + blockIdx.x;
  const int col0 = blockIdx.y * NC;
  const double* p = p_u + static_cast<size_t>(lane_g) * s2 * s2;
  double* z = zp + static_cast<size_t>(row_base - lane_g * s2) * k + col0;
  const int ns = s2r / kBK64, nrb = (s2 + kBM64 - 1) / kBM64;
  const int total = ns * nrb;

  auto load_p = [&](int q) {
    const int i0 = (q / ns) * kBM64, l0 = (q % ns) * kBK64;
    stage_v<double, kVecP>(ps + (q & 1) * kBM64 * kSA64, kSA64,
                           p + static_cast<size_t>(i0) * s2 + l0, s2, kBM64,
                           kBK64, s2 - i0, s2 - l0);
  };
  stage_v<double, kVecZ>(zs, SZ, z, k, s2r, NC, s2, k - col0);
  load_p(0);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp >> 1, wc = warp & 1;
  const int fr = lane >> 2, fk = lane & 3;
  for (int rb = 0, q = 0; rb < nrb; ++rb) {   // passes of kBM64 rows
    double acc[2][WN][4] = {};
    for (int sl = 0; sl < ns; ++sl, ++q) {   // depth slices of P
      if (q + 1 < total) {
        load_p(q + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const double* pa =
          ps + (q & 1) * kBM64 * kSA64 + (wr * 32 + fr) * kSA64 + fk;
      const double* zb = zs + static_cast<size_t>(sl * kBK64 + fk) * SZ +
                         wc * 8 * WN + fr;
#pragma unroll
      for (int kk = 0; kk < kBK64; kk += 4)
        warp_k4<WN>(acc, pa + kk, kSA64, zb + kk * SZ);
      __syncthreads();
    }
    // the pass is done: its rows go back in place
    warp_store<WN, kVecZ>(acc, z, k, rb * kBM64 + wr * 32 + fr, s2,
                          wc * 8 * WN, k - col0, fk);
  }
}

// ---- float32: CUDA-core register tiles -------------------------------------

constexpr int kBK32 = 16;
constexpr int kSA32 = kBK32 + 4;

// TX x TY threads; thread (tx, ty) owns rows ty + TY q (q < 8) and columns
// 4 tx + [0, 4) and 4 TX + 4 tx + [0, 4): NC = 8 TX, BM = 8 TY.
template <bool kVecP, bool kVecZ, int TX>
__global__ void __launch_bounds__(kThreads)
    wf_bt_f32_kernel(const float* __restrict__ p_u, float* __restrict__ zp,
                     int k, int s2, int row_base, int g_lo) {
  constexpr int TY = kThreads / TX, NC = 8 * TX, BM = 8 * TY, SZ = NC + 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int s2r = (s2 + kBK32 - 1) / kBK32 * kBK32;
  float* zs = reinterpret_cast<float*>(smem_raw);        // (s2r, SZ)
  float* ps = zs + static_cast<size_t>(s2r) * SZ;        // 2 x (BM, kSA32)

  const int lane_g = g_lo + blockIdx.x;
  const int col0 = blockIdx.y * NC;
  const float* p = p_u + static_cast<size_t>(lane_g) * s2 * s2;
  float* z = zp + static_cast<size_t>(row_base - lane_g * s2) * k + col0;
  const int ns = s2r / kBK32, nrb = (s2 + BM - 1) / BM;
  const int total = ns * nrb;

  auto load_p = [&](int q) {
    const int i0 = (q / ns) * BM, l0 = (q % ns) * kBK32;
    stage_v<float, kVecP>(ps + (q & 1) * BM * kSA32, kSA32,
                          p + static_cast<size_t>(i0) * s2 + l0, s2, BM,
                          kBK32, s2 - i0, s2 - l0);
  };
  stage_v<float, kVecZ>(zs, SZ, z, k, s2r, NC, s2, k - col0);
  load_p(0);
  cp_async_commit();

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  float acc[8][8];
  for (int q = 0; q < total; ++q) {
    if (q + 1 < total) {
      load_p(q + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int sl = q % ns;
    if (sl == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    const float* pa = ps + (q & 1) * BM * kSA32 + ty * kSA32;
    const float* zb = zs + static_cast<size_t>(sl * kBK32) * SZ + 4 * tx;
#pragma unroll
    for (int l = 0; l < kBK32; ++l) {
      float a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = pa[i * TY * kSA32 + l];
      const float4 z0 = *reinterpret_cast<const float4*>(zb + l * SZ);
      const float4 z1 = *reinterpret_cast<const float4*>(zb + l * SZ + 4 * TX);
      const float zv[8] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], zv[j], acc[i][j]);
    }
    __syncthreads();
    if (sl == ns - 1) {
      const int i0 = (q / ns) * BM + ty;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = i0 + i * TY;
        if (row >= s2) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 4 * tx + (j & 3) + (j >> 2) * 4 * TX;
          if (col0 + c < k) z[static_cast<size_t>(row) * k + c] = acc[i][j];
        }
      }
    }
  }
}

// ---- the resident branch (S2 <= 128): P stays in shared memory -------------
//
// One CTA per (live lane, column split): it stages the lane's whole P once
// and walks the split's z tiles (every gridDim.y-th tile of kResNC64 /
// kResNC32 columns), double-buffered with cp.async, so P leaves L2 once per
// split instead of once per tile.  The host picks the splits so that the
// live lanes times the splits fill the SMs.

constexpr int kResRows = 128;             // rows of P (S2 <= 128)
constexpr int kResNC64 = 32;
constexpr int kResNC32 = 128;

__host__ __device__ constexpr int res_depth(int s2, int mult) {
  return (s2 + mult - 1) / mult * mult;
}

template <bool kVecP, bool kVecZ>
__global__ void __launch_bounds__(kThreads, 1)
    wf_bt_f64_resident(const double* __restrict__ p_u,
                       double* __restrict__ zp, int k, int s2, int row_base,
                       int g_lo) {
  constexpr int NC = kResNC64, SZ = NC + 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int s2r = res_depth(s2, 8), SP = s2r + 4;
  double* ps = reinterpret_cast<double*>(smem_raw);      // (kResRows, SP)
  double* zs = ps + kResRows * SP;                       // 2 x (s2r, SZ)

  const int lane_g = g_lo + blockIdx.x;
  const double* p = p_u + static_cast<size_t>(lane_g) * s2 * s2;
  double* z = zp + static_cast<size_t>(row_base - lane_g * s2) * k;
  const int ntiles = (k + NC - 1) / NC, splits = gridDim.y;
  auto load_z = [&](int tile, int buf) {
    const int col0 = tile * NC;
    stage_v<double, kVecZ>(zs + buf * s2r * SZ, SZ, z + col0, k, s2r, NC, s2,
                           k - col0);
  };
  // P in four depth quarters (cp.async groups 0-3, the first tile of z
  // with quarter 0): the first tile computes on each quarter as it lands
  const int dq = res_depth((s2r + 3) / 4, 4);      // a multiple of 4
  for (int qd = 0; qd < 4; ++qd) {
    const int l0 = qd * dq;
    if (l0 < s2r)
      stage_v<double, kVecP>(ps + l0, SP, p + l0, s2, kResRows,
                             l0 + dq < s2r ? dq : s2r - l0, s2, s2 - l0);
    if (qd == 0) load_z(blockIdx.y, 0);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp >> 1, wc = warp & 1;
  const int fr = lane >> 2, fk = lane & 3;
  const double* pa = ps + (wr * 32 + fr) * SP + fk;   // A[g][t], warp rows
  int it = 0;
  for (int tile = blockIdx.y; tile < ntiles; tile += splits, ++it) {
    const bool more = tile + splits < ntiles;
    if (more) {
      load_z(tile + splits, (it + 1) & 1);
      cp_async_commit();
    }
    double acc[2][2][4] = {};
    const double* zb = zs + (it & 1) * s2r * SZ + fk * SZ + wc * 16 + fr;
    for (int qd = 0; qd < (it == 0 ? 4 : 1); ++qd) {
      // groups still allowed in flight: the quarters after qd, the next tile
      cp_async_wait_n((it == 0 ? 3 - qd : 0) + (more ? 1 : 0));
      __syncthreads();
      const int k0 = it == 0 ? qd * dq : 0;
      const int k1 = it == 0 && qd < 3 ? min(k0 + dq, s2r) : s2r;
#pragma unroll 4
      for (int kk = k0; kk < k1; kk += 4)
        warp_k4<2>(acc, pa + kk, SP, zb + kk * SZ);
    }
    if (kVecZ)
      warp_store<2, true>(acc, z, k, wr * 32 + fr, s2, tile * NC + wc * 16,
                          k, fk);
    else
      warp_store<2, false>(acc, z, k, wr * 32 + fr, s2, tile * NC + wc * 16,
                           k, fk);
    __syncthreads();   // the buffer is refilled by the next pass
  }
}

template <bool kVecP, bool kVecZ>
__global__ void __launch_bounds__(kThreads, 1)
    wf_bt_f32_resident(const float* __restrict__ p_u, float* __restrict__ zp,
                       int k, int s2, int row_base, int g_lo) {
  constexpr int TX = 16, TY = kThreads / TX, NC = kResNC32, SZ = NC + 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int s2r = res_depth(s2, 4), SP = s2r + 4;
  float* ps = reinterpret_cast<float*>(smem_raw);        // (kResRows, SP)
  float* zs = ps + kResRows * SP;                        // 2 x (s2r, SZ)

  const int lane_g = g_lo + blockIdx.x;
  const float* p = p_u + static_cast<size_t>(lane_g) * s2 * s2;
  float* z = zp + static_cast<size_t>(row_base - lane_g * s2) * k;
  const int ntiles = (k + NC - 1) / NC, splits = gridDim.y;
  auto load_z = [&](int tile, int buf) {
    const int col0 = tile * NC;
    stage_v<float, kVecZ>(zs + buf * s2r * SZ, SZ, z + col0, k, s2r, NC, s2,
                          k - col0);
  };
  stage_v<float, kVecP>(ps, SP, p, s2, kResRows, s2r, s2, s2);
  load_z(blockIdx.y, 0);
  cp_async_commit();

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const float* pa = ps + ty * SP;
  int it = 0;
  for (int tile = blockIdx.y; tile < ntiles; tile += splits, ++it) {
    if (tile + splits < ntiles) {
      load_z(tile + splits, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float acc[8][8] = {};
    const float* zb = zs + (it & 1) * s2r * SZ + 4 * tx;
#pragma unroll 4
    for (int l = 0; l < s2r; ++l) {
      float a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = pa[i * TY * SP + l];
      const float4 z0 = *reinterpret_cast<const float4*>(zb + l * SZ);
      const float4 z1 = *reinterpret_cast<const float4*>(zb + l * SZ + 4 * TX);
      const float zv[8] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], zv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = ty + i * TY;
      if (row >= s2) continue;
      float* zr = z + static_cast<size_t>(row) * k;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = tile * NC + 4 * tx + h * 4 * TX;
        if constexpr (kVecZ) {       // k % 4 == 0: four columns at once
          if (c < k)
            *reinterpret_cast<float4*>(zr + c) =
                make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                            acc[i][4 * h + 2], acc[i][4 * h + 3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c + e < k) zr[c + e] = acc[i][4 * h + e];
        }
      }
    }
    __syncthreads();
  }
}

// ---- host ------------------------------------------------------------------

int floor_div(int a, int b) {             // b > 0
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

using KernelFn = void (*)(const void*, void*, int, int, int, int);

struct Variant {
  KernelFn fn;
  int nc;          // z columns per tile
  size_t smem;     // bytes of shared memory
  bool resident;   // P in shared memory, tiles split over gridDim.y
};

template <typename Kern>
KernelFn as_fn(Kern k) {
  return reinterpret_cast<KernelFn>(k);
}

// The resident branch where S2 <= 128; else the streamed branch with the
// widest column tile whose z window fits in shared memory.  16-byte copies
// where P's row length (s2) and z's row stride (k) allow them.
template <typename T>
Variant pick(int s2, int k);

// KERN<kVecP, kVecZ[, W]> for the copy widths vp, vz allow
#define EK_PICK(KERN, ...)                                          \
  (vp ? (vz ? as_fn(KERN<true, true __VA_ARGS__>)                   \
            : as_fn(KERN<true, false __VA_ARGS__>))                 \
      : (vz ? as_fn(KERN<false, true __VA_ARGS__>)                  \
            : as_fn(KERN<false, false __VA_ARGS__>)))

template <>
Variant pick<double>(int s2, int k) {
  const bool vp = s2 % 2 == 0, vz = k % 2 == 0;
  if (s2 <= kResRows) {
    const int s2r = res_depth(s2, 8);
    return {EK_PICK(wf_bt_f64_resident, ), kResNC64,
            (kResRows * (s2r + 4) + 2 * s2r * (kResNC64 + 4)) *
                sizeof(double),
            true};
  }
  const int s2r = res_depth(s2, kBK64);
  const size_t pbytes = 2 * kBM64 * kSA64 * sizeof(double);
  const size_t wide = s2r * (64 + 4) * sizeof(double) + pbytes;
  if (wide <= kSmemMax) return {EK_PICK(wf_bt_f64_kernel, , 4), 64, wide, false};
  return {EK_PICK(wf_bt_f64_kernel, , 1), 16,
          s2r * (16 + 4) * sizeof(double) + pbytes, false};
}

template <>
Variant pick<float>(int s2, int k) {
  const bool vp = s2 % 4 == 0, vz = k % 4 == 0;
  if (s2 <= kResRows) {
    const int s2r = res_depth(s2, 4);
    return {EK_PICK(wf_bt_f32_resident, ), kResNC32,
            (kResRows * (s2r + 4) + 2 * s2r * (kResNC32 + 4)) * sizeof(float),
            true};
  }
  const int s2r = res_depth(s2, kBK32);
  const size_t wide = s2r * (128 + 4) * sizeof(float) +
                      2 * (8 * kThreads / 16) * kSA32 * sizeof(float);
  if (wide <= kSmemMax) return {EK_PICK(wf_bt_f32_kernel, , 16), 128, wide, false};
  return {EK_PICK(wf_bt_f32_kernel, , 4), 32,
          s2r * (32 + 4) * sizeof(float) +
              2 * (8 * kThreads / 4) * kSA32 * sizeof(float),
          false};
}

#undef EK_PICK

template <typename T>
int launch(const void* p, void* zp, int k, int n, int b, int g, int m,
           int n_groups, int tm, int top, int u0, int tc, int* launched,
           int* resident, void* stream) {
  const int s2 = g + m * b;
  const int kk = n - 1 - g;                 // nsweeps + 1 - g
  const Variant var = pick<T>(s2, k);
  *resident = var.resident ? 1 : 0;
  if (var.smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(var.fn),
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(var.smem));
  int dev = 0, sms = 1;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int col_tiles = (k + var.nc - 1) / var.nc;
  int count = 0;
  for (int uu = 0; uu < tc; ++uu) {
    const int u = u0 + uu;
    int g_lo = u - (tm - 1);
    if (g_lo < 0) g_lo = 0;
    const int g_tail = floor_div(m * b * u + kk - n, s2) + 1;
    if (g_tail > g_lo) g_lo = g_tail;
    const int g_hi = (n_groups - 1 < u) ? n_groups - 1 : u;
    if (g_lo > g_hi) continue;
    const int lanes = g_hi - g_lo + 1;
    // resident: one CTA per SM (the shared memory), so split the columns
    // until the lanes fill the SMs; streamed: one CTA per column tile
    int ny = col_tiles;
    if (var.resident) {
      ny = sms / lanes;
      if (ny < 1) ny = 1;
      if (ny > col_tiles) ny = col_tiles;
    }
    const void* p_u = static_cast<const T*>(p) +
                      static_cast<size_t>(uu) * n_groups * s2 * s2;
    int row_base = kk + m * b * u + top;
    void* args[] = {&p_u, &zp, &k, const_cast<int*>(&s2), &row_base, &g_lo};
    err = cudaLaunchKernel(reinterpret_cast<const void*>(var.fn),
                           dim3(lanes, ny), dim3(kThreads), args, var.smem,
                           static_cast<cudaStream_t>(stream));
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
// launches, *resident 1 for the resident branch, 0 for the streamed one.
// Returns the first CUDA error, else 0.
extern "C" int ek_wf_bt_f64(const void* p, void* zp, int k, int n, int b,
                            int g, int m, int n_groups, int tm, int top,
                            int u0, int tc, int* launched, int* resident,
                            void* stream) {
  return launch<double>(p, zp, k, n, b, g, m, n_groups, tm, top, u0, tc,
                        launched, resident, stream);
}

extern "C" int ek_wf_bt_f32(const void* p, void* zp, int k, int n, int b,
                            int g, int m, int n_groups, int tm, int top,
                            int u0, int tc, int* launched, int* resident,
                            void* stream) {
  return launch<float>(p, zp, k, n, b, g, m, n_groups, tm, top, u0, tc,
                       launched, resident, stream);
}
