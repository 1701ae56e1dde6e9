// Batched shifted tridiagonal solves (T - lam_j I) x_j = b_j, the inner
// step of inverse iteration, one thread per system and one warp per block.
//
// Replaces: eigenkernel_tpu/ops/pallas_solve.py::tridiag_solve_pallas
// (Pallas kernel _solve_kernel), which pads n to 256-row chunks and k to
// 1024-lane tiles and streams u, y and x through HBM scratch.
//
// Recurrences (LU without pivoting, dstein-style pivot floor):
//   forward:  l = e_{i-1} / u_{i-1}
//             u_i = (d_i - lam) - e_{i-1} l,   |u_i| floored at +-tiny
//             y_i = b_i - l y_{i-1}
//   backward: x_i = (y_i - e_i x_{i+1}) / u_i
// The pivot floor `tiny` is an argument: inverse iteration passes
// eps * max|T| as LAPACK's dstein does, where the Pallas kernel fixes
// 1e-30 (float64) / 1e-25 (float32).  An absolute 1e-30 lets a shift
// that zeroes a leading minor exactly (glued Wilkinson matrices) grow
// multipliers of 1e30, and the rounding of that growth swamps the
// eigenvector.
// Products are rounded on their own (mul_rn), never fused into an FMA with
// the following subtraction: the kernel then rounds exactly as its plain
// PyTorch version, which matters in float32, where a near-singular shift
// amplifies a one-ulp difference in a pivot to 1e-4 in the solution.
//
// Layout: b, u, y and x are (n, k) row-major, so row i of a block's 32
// systems is 32 neighbouring words (256 bytes in float64).
//
// What bounds it on the card: each row of a sweep is a dependent step
// whose chain holds an IEEE division, so a system costs 2 n division-chain
// latencies whatever the card's width; the bytes, about 6 n k itemsize
// (read b, write u and y, read u and y, write x), come second.  A load
// from device memory inside the row loop would add its latency to every
// row.
//
// What the design does about it: no device-memory load on the row chain.
// A block is one warp of 32 systems (k = 500 runs 16 blocks, k = 4096
// 128).  The forward sweep stages chunks of kRows rows of b (the warp's
// 32 columns), d and e_{i-1} in shared memory, double-buffered with
// cp.async: the next chunk is in flight while the current one runs.  The
// backward sweep stages chunks of u, y and e_i the same way, in reverse
// order.  Rows run in groups of 8: a group's operands are read from shared
// memory before its first step and its results stored after its last, so
// that only the division chain runs between two rows.  Copies are 16
// bytes where k and the base pointers allow it (k even in float64, a
// multiple of 4 in float32), else one element.  u, y and x leave as row
// stores of the warp's 32 neighbouring words, which coalesce and never
// stall the chain; u and y of all n rows cannot stay on chip (32 systems x
// n = 16384 x 2 words is 8 MB), so they go to device memory once and come
// back once.  The arithmetic and its order are those of the plain
// version, so the result is bit for bit the plain version's.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kCols = 32;    // systems per block: one warp
constexpr int kRows = 64;    // rows per staged chunk
constexpr int kStages = 2;
constexpr int kGroup = 8;    // rows whose operands are read together

__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}

// Keep v in a register from here on: the compiler may neither sink the
// load or the operation that makes it towards its use nor make it again
// there.
__device__ __forceinline__ void pin(double& v) { asm volatile("" : "+d"(v)); }
__device__ __forceinline__ void pin(float& v) { asm volatile("" : "+f"(v)); }

// One forward row: l = e_{i-1} / u_{i-1}, u_i = (d_i - lam) - e_{i-1} l
// floored at +-tiny (ntiny = -tiny), y_i = b_i - l y_{i-1}; (u, y) carry
// row i - 1 in and row i out.
template <typename T>
__device__ __forceinline__ void fwd_row(T& u, T& y, T el, T dm, T bi,
                                        T tiny, T ntiny) {
  const T l = el / u;
  T ui = dm - mul_rn(el, l);
  if (fabs(ui) < tiny) ui = (ui < T(0)) ? ntiny : tiny;
  y = bi - mul_rn(l, y);
  u = ui;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(kBytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Stage rows [r0, r0 + rows) of the block's columns [j0, j0 + 32) of the
// (n, k) array src into dst (kRows x kCols) with copies of V elements.  A
// column at or past k copies column k - V instead, so the lanes that store
// nothing still run on real data (no slow path of the division on
// garbage).  With V > 1, k and src are multiples of V elements and 16
// bytes.
template <typename T, int V>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int r0,
                                           int rows, int k, int j0) {
  constexpr int kPer = kCols / V;  // copies per row
  for (int q = threadIdx.x; q < rows * kPer; q += kCols) {
    const int r = q / kPer, c = (q - r * kPer) * V;
    cp_async<static_cast<int>(V * sizeof(T))>(
        dst + r * kCols + c,
        src + static_cast<size_t>(r0 + r) * k + min(j0 + c, k - V));
  }
}

// Stage vec[r0 + off + r] for r in [0, rows) into dst, 0 where that
// index falls outside [0, len).
template <typename T>
__device__ __forceinline__ void stage_vec(T* dst, const T* vec, int r0,
                                          int off, int rows, int len) {
  for (int r = threadIdx.x; r < rows; r += kCols) {
    const int at = r0 + off + r;
    if (at >= 0 && at < len) {
      cp_async<static_cast<int>(sizeof(T))>(dst + r, vec + at);
    } else {
      dst[r] = T(0);
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kCols)
    tridiag_solve_kernel(const T* __restrict__ d, const T* __restrict__ e,
                         const T* __restrict__ lam, const T* __restrict__ b,
                         T* __restrict__ u, T* __restrict__ y,
                         T* __restrict__ x, int n, int k, T tiny) {
  extern __shared__ __align__(16) unsigned char smem[];
  // [kStages][kRows][kCols] b (forward) or u (backward), the same for y
  // (backward), [kStages][kRows] d (forward) and e_{i-1} / e_i
  T* s_bu = reinterpret_cast<T*>(smem);
  T* s_y = s_bu + kStages * kRows * kCols;
  T* s_d = s_y + kStages * kRows * kCols;
  T* s_e = s_d + kStages * kRows;
  const int lane = threadIdx.x;
  const int j0 = blockIdx.x * kCols;
  const int j = j0 + lane;
  const bool live = j < k;
  const T lj = lam[live ? j : k - 1];
  const size_t ld = static_cast<size_t>(k);
  const int chunks = (n + kRows - 1) / kRows;
  const int tail = n - (chunks - 1) * kRows;  // rows of the last chunk
  T ntiny = -tiny;
  pin(ntiny);

  // forward: chunk c in stage c % kStages
  auto stage_fwd = [&](int c) {
    const int s = c % kStages, r0 = c * kRows;
    const int rows = c == chunks - 1 ? tail : kRows;
    stage_rows<T, V>(s_bu + s * kRows * kCols, b, r0, rows, k, j0);
    stage_vec(s_d + s * kRows, d, r0, 0, rows, n);
    stage_vec(s_e + s * kRows, e, r0, -1, rows, n - 1);  // e_{-1} = 0
    cp_async_commit();
  };
  T u_prev = T(1);
  T y_prev = T(0);
  stage_fwd(0);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      stage_fwd(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int s = c % kStages, r0 = c * kRows;
    const int rows = c == chunks - 1 ? tail : kRows;
    const T* cb = s_bu + s * kRows * kCols + lane;
    const T* cd = s_d + s * kRows;
    const T* ce = s_e + s * kRows;
    T* cu = u + static_cast<size_t>(r0) * ld + j;
    T* cy = y + static_cast<size_t>(r0) * ld + j;
    int r = 0;
    for (; r + kGroup <= rows; r += kGroup) {
      T el[kGroup], dm[kGroup], bi[kGroup], uo[kGroup], yo[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        el[g] = ce[r + g];
        dm[g] = cd[r + g] - lj;
        bi[g] = cb[(r + g) * kCols];
        pin(el[g]);
        pin(dm[g]);
        pin(bi[g]);
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        fwd_row(u_prev, y_prev, el[g], dm[g], bi[g], tiny, ntiny);
        uo[g] = u_prev;
        yo[g] = y_prev;
      }
      if (live) {
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          cu[(r + g) * ld] = uo[g];
          cy[(r + g) * ld] = yo[g];
        }
      }
    }
    for (; r < rows; ++r) {
      fwd_row(u_prev, y_prev, ce[r], cd[r] - lj, cb[r * kCols], tiny,
              ntiny);
      if (live) {
        cu[r * ld] = u_prev;
        cy[r * ld] = y_prev;
      }
    }
    __syncthreads();  // the next round's copies refill this stage
  }

  // backward: the t-th chunk from the end in stage t % kStages; the
  // barrier above also makes the warp's u and y stores visible to it
  auto stage_bwd = [&](int t) {
    const int c = chunks - 1 - t, s = t % kStages, r0 = c * kRows;
    const int rows = c == chunks - 1 ? tail : kRows;
    stage_rows<T, V>(s_bu + s * kRows * kCols, u, r0, rows, k, j0);
    stage_rows<T, V>(s_y + s * kRows * kCols, y, r0, rows, k, j0);
    stage_vec(s_e + s * kRows, e, r0, 0, rows, n - 1);  // e_{n-1} = 0
    cp_async_commit();
  };
  T x_next = T(0);
  stage_bwd(0);
  for (int t = 0; t < chunks; ++t) {
    if (t + 1 < chunks) {
      stage_bwd(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int c = chunks - 1 - t, s = t % kStages, r0 = c * kRows;
    const int rows = c == chunks - 1 ? tail : kRows;
    const T* cu = s_bu + s * kRows * kCols + lane;
    const T* cy = s_y + s * kRows * kCols + lane;
    const T* ce = s_e + s * kRows;
    T* cx = x + static_cast<size_t>(r0) * ld + j;
    int r = rows;  // rows [r - kGroup, r), last first
    for (; r >= kGroup; r -= kGroup) {
      T yv[kGroup], uv[kGroup], ev[kGroup], xo[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        yv[g] = cy[(r - 1 - g) * kCols];
        uv[g] = cu[(r - 1 - g) * kCols];
        ev[g] = ce[r - 1 - g];
        pin(yv[g]);
        pin(uv[g]);
        pin(ev[g]);
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        x_next = (yv[g] - mul_rn(ev[g], x_next)) / uv[g];
        xo[g] = x_next;
      }
      if (live) {
#pragma unroll
        for (int g = 0; g < kGroup; ++g) cx[(r - 1 - g) * ld] = xo[g];
      }
    }
    for (; r > 0; --r) {
      x_next = (cy[(r - 1) * kCols] - mul_rn(ce[r - 1], x_next)) /
               cu[(r - 1) * kCols];
      if (live) cx[(r - 1) * ld] = x_next;
    }
    __syncthreads();
  }
}

constexpr size_t smem_bytes(size_t itemsize) {
  return (2 * kStages * kRows * kCols + 2 * kStages * kRows) * itemsize;
}

template <typename T, int V>
int launch_v(const T* d, const T* e, const T* lam, const T* b, T* u, T* y,
             T* x, int n, int k, T tiny, cudaStream_t stream) {
  const size_t smem = smem_bytes(sizeof(T));
  const cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&tridiag_solve_kernel<T, V>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (k + kCols - 1) / kCols;
  tridiag_solve_kernel<T, V><<<blocks, kCols, smem, stream>>>(
      d, e, lam, b, u, y, x, n, k, tiny);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* d, const void* e, const void* lam, const void* b,
           void* u, void* y, void* x, int n, int k, T tiny, void* stream) {
  constexpr int kVec = static_cast<int>(16 / sizeof(T));
  const bool aligned = k % kVec == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const auto args = [&](auto v) {
    return launch_v<T, decltype(v)::value>(
        static_cast<const T*>(d), static_cast<const T*>(e),
        static_cast<const T*>(lam), static_cast<const T*>(b),
        static_cast<T*>(u), static_cast<T*>(y), static_cast<T*>(x), n, k,
        tiny, static_cast<cudaStream_t>(stream));
  };
  return aligned ? args(std::integral_constant<int, kVec>())
                 : args(std::integral_constant<int, 1>());
}

}  // namespace

// d (n,), e (n-1,), lam (k,), b / u / y / x (n, k) row-major; u and y
// are scratch; tiny is the pivot floor.  Returns cudaGetLastError() after
// the launch.
extern "C" int ek_tridiag_solve_f64(const void* d, const void* e,
                                    const void* lam, const void* b, void* u,
                                    void* y, void* x, int n, int k,
                                    double tiny, void* stream) {
  return launch<double>(d, e, lam, b, u, y, x, n, k, tiny, stream);
}

extern "C" int ek_tridiag_solve_f32(const void* d, const void* e,
                                    const void* lam, const void* b, void* u,
                                    void* y, void* x, int n, int k,
                                    float tiny, void* stream) {
  return launch<float>(d, e, lam, b, u, y, x, n, k, tiny, stream);
}

// Rows of a staged chunk (ops/tridiag_solve.py's ROWS).
extern "C" int ek_tridiag_solve_rows() { return kRows; }
