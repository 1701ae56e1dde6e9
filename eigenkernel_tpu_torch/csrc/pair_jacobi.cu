// Batched symmetric eigh of small blocks by two-sided cyclic Jacobi (D2),
// a cluster of two CTAs a block.
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
// then the rows p, q (x_p <- c x_p - s x_q, x_q <- s x_p + c x_q), the
// columns (a_pq, a_qp set to exactly 0) and the rows of V^T.  A block
// stops after a sweep without a rotation, or after max_sweeps, and writes
// the sweeps it ran and the rotations it applied.
//
// Arithmetic: every product and sum is rounded on its own (__dmul_rn,
// __dadd_rn and the float forms: no contraction into FMAs), and sqrt and
// division are the IEEE ones, so the result equals, bit for bit, the plain
// PyTorch version (ops/jacobi.py::pair_eigh_plain), which evaluates the
// same expressions with one rounding per operation.
//
// What bounds it on the card: the chain.  A sweep is w - 1 dependent sets,
// each a rotation's parameters (two square roots and three divisions in a
// row) and the update of A that feeds the next set's parameters.  The
// bytes (the block read once, values and vectors written once) are far
// below the memory rate; the update of a set moves the whole block through
// shared memory once (w^2 reads and writes, 256 KB in float64 at w = 128:
// ~2,000 cycles of shared-memory bandwidth) and V^T's rows as much again.
//
// What the design does about it:
// - A cluster of two CTAs a block (2m CTAs).  CTA 0 holds A in shared
//   memory (row stride w + 1) and runs the chain: the parameters (a thread
//   a pair), then the update of A.  CTA 1 holds V^T in its own shared
//   memory and applies each set's rotations to it, one or more sets behind:
//   CTA 0's parameter threads store a set's (c, s, pair, flag) into a ring
//   of up to kRing slots (fewer where a wide block's tables do not fit) in
//   CTA 1's shared memory (distributed shared memory) by st.async, which
//   completes its bytes on the slot's mbarrier there, so no fence sits on
//   the chain; CTA 1 frees a slot by an arrival on CTA 0's barrier at
//   cluster scope.  V^T is off the chain and out of L2, and sets are
//   applied in order, so its bits are those of the plain version's.
// - The rows and the columns in one pass of 2 x 2 tiles: for pairs (p, q)
//   and (r, s) a thread loads A[{p,q},{r,s}], applies the row rotation of
//   (p, q) and then the column rotation of (r, s) in registers, and writes
//   the four results (a_pq = a_qp = 0 on diagonal tiles).  The column step
//   of a row reads only that tile's row-rotated entries, so this is the
//   plain version's sequence of roundings, with one barrier and one pass
//   over A fewer.  A warp walks one row pair and 32 column pairs, and its
//   lanes load column x and column y of the circle method's pair (x, y)
//   (p = min, q = max; the table's sine is signed to match, so no lane
//   reorders entries): consecutive columns, so bank-conflict free.  A
//   thread loads four tiles (disjoint entries) before it stores any, and
//   CTA 1 four rows of V^T, so that loads overlap.
// - At w = 128 (b = 64, the path's width) the kernel is compiled for that
//   width: a thread's column pair is fixed, its row pairs come by shifts,
//   and A and V^T are __shared__ arrays.  Other widths run the same kernel
//   with a runtime w, a thread looping over pairs where there are more
//   pairs than threads; where the block (or V^T) does not fit in shared
//   memory it lives in a scratch buffer (or the output) in global memory.
//   The widest block is that whose tables still fit one slot of the ring
//   (w <= 23,242 in float64), and at most 32,767 (the packed pair).
// - No shared atomics: a set's rotations are counted by the barrier that
//   follows the parameters (__syncthreads_count, once for each bit of a
//   thread's count where a thread has more than one pair), which also
//   tells the sweep without a rotation; CTA 1 mirrors the stop rule with
//   __syncthreads_or.
//
// The EK_PROBE_* marks are empty here; tools/pair_jacobi_profile.py
// defines them to count the cycles of each phase and barrier.

#include <cfloat>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#ifndef EK_PROBE
#define EK_PROBE_BEGIN()
#define EK_PROBE_ARRIVE()
#define EK_PROBE(k)
#define EK_PROBE_MARK(k)
#define EK_PROBE_END(sets)
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSmem = 232448;  // opt-in dynamic shared memory, sm_90
constexpr int kRing = 8;          // slots of set parameters in CTA 1, at most
constexpr int kMaxWidth = 32767;  // x and y of a packed pair: 15 bits
constexpr int kFixedWidth = 128;  // the width compiled as a constant

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

// (c, s) as one vector load
template <typename T>
struct Vec2;
template <>
struct Vec2<double> {
  using type = double2;
};
template <>
struct Vec2<float> {
  using type = float2;
};

// --- mbarriers across the cluster -------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar,
                                         unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// One arrival on the barrier at the same offset of CTA `rank`'s shared
// memory; it releases this thread's earlier writes at cluster scope.
__device__ __forceinline__ void bar_arrive_remote(unsigned long long* bar,
                                                  unsigned rank) {
  asm volatile(
      "{\n\t.reg .b32 ra;\n\t"
      "mapa.shared::cluster.u32 ra, %0, %1;\n\t"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\n\t}" ::
          "r"(smem_addr(bar)),
      "r"(rank)
      : "memory");
}

// Arm the local barrier for its next phase: one arrival that expects
// `bytes` to land by st.async.
__device__ __forceinline__ void bar_expect(unsigned long long* bar,
                                           unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the completion of the barrier's phase of the given parity,
// acquiring at cluster scope what the arrivals released.
__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  const unsigned addr = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// The address of `local`'s counterpart in CTA `rank`'s shared memory.
__device__ __forceinline__ unsigned remote(const void* local,
                                           unsigned rank) {
  unsigned ra;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(ra)
               : "r"(smem_addr(local)), "r"(rank));
  return ra;
}

// Non-blocking stores into another CTA's shared memory, each completing
// its bytes on that CTA's barrier `bar` (shared::cluster addresses): no
// fence on the storing thread.
__device__ __forceinline__ void st_async(unsigned at, double2 v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f64 [%0], "
      "{%1, %2}, [%3];" ::"r"(at),
      "d"(v.x), "d"(v.y), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async(unsigned at, float2 v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];" ::"r"(at),
      "f"(v.x), "f"(v.y), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async(unsigned at, int v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(at),
      "r"(v), "r"(bar)
      : "memory");
}

// --- layout -----------------------------------------------------------

// A set's table: (c, s) of each pair in the working type, s signed (s
// where x < y, else -s) so that the rotation applies in the circle
// method's (x, y) order (p = min, q = max), then the pair packed with its
// flag as an int, x | y << 15 | (flag + 1) << 30 (w <= kMaxWidth; flag 1
// rotate, 0 skip, -1 bye); 16-byte aligned.  The ring has `ring` slots:
// kRing, or as many tables as fit where a wide block's do not (0: the
// width does not fit at all).  CTA 0: its own table, `ring` mbarriers
// ("slot free"), then A (w rows of stride w + 1) if it fits.  CTA 1:
// `ring` tables (the ring), `ring` mbarriers ("slot full"), then V^T
// (w x w) if it fits.  Both CTAs launch with the larger of the two sizes.
struct Layout {
  int table, bytes, ring, cta0, cta1, smem, a_res, v_res;
};

__host__ __device__ inline Layout layout(int w, int isz) {
  const int P = (w + 1) / 2;
  Layout L;
  L.bytes = P * (2 * isz + 4);  // what a set sends
  L.table = (L.bytes + 15) & ~15;
  const int fit = kMaxSmem / (L.table + 8);
  L.ring = fit < kRing ? fit : kRing;
  L.cta0 = L.table + L.ring * 8;
  L.cta1 = L.ring * (L.table + 8);
  const long long a_bytes = 1LL * w * (w + 1) * isz;
  const long long v_bytes = 1LL * w * w * isz;
  L.a_res = L.cta0 + a_bytes <= kMaxSmem;
  L.v_res = L.cta1 + v_bytes <= kMaxSmem;
  if (L.a_res) L.cta0 += static_cast<int>(a_bytes);
  if (L.v_res) L.cta1 += static_cast<int>(v_bytes);
  L.smem = L.cta0 > L.cta1 ? L.cta0 : L.cta1;
  return L;
}

template <typename T>
struct Table {
  typename Vec2<T>::type* cs;
  int* pk;
  __device__ Table(unsigned char* base, int P)
      : cs(reinterpret_cast<typename Vec2<T>::type*>(base)),
        pk(reinterpret_cast<int*>(base + 2 * P * sizeof(T))) {}
};

__device__ __forceinline__ int pack(int x, int y, int f) {
  return static_cast<int>(static_cast<unsigned>(x) |
                          (static_cast<unsigned>(y) << 15) |
                          (static_cast<unsigned>(f + 1) << 30));
}
__device__ __forceinline__ int flag_of(int pk) {
  return static_cast<int>(static_cast<unsigned>(pk) >> 30) - 1;
}
__device__ __forceinline__ int x_of(int pk) { return pk & 0x7fff; }
__device__ __forceinline__ int y_of(int pk) { return (pk >> 15) & 0x7fff; }

// --- CTA 0: the chain ---------------------------------------------------

// One 2 x 2 tile: rows {x_i, y_i} by columns {x_j, y_j} in the circle
// method's order, the row rotation of pair i then the column rotation of
// pair j.  With the table's signed sine (s where x < y, else -s) the
// rotation in (x, y) order is the one in (p, q) order, bit for bit:
// negation is exact and sums commute.  The lanes of a warp share i and
// take consecutive j, so consecutive columns.  load(), rotate() and
// store() are apart so that a thread can load several tiles (disjoint
// entries) before it stores any.  kByes: odd w, a pair may hold index w.
template <typename T, bool kByes>
struct Tile {
  T* rx;
  T* ry;
  int xj, yj, fi, fj;
  bool live, zero, ok0, ok1, ok2, ok3;
  T e00, e01, e10, e11;  // row x_i: (col x_j, col y_j); row y_i

  __device__ __forceinline__ void load(T* A, int lda, int w, int i, int j,
                                       int pki, int pkj) {
    fi = flag_of(pki);
    fj = flag_of(pkj);
    const bool diag = i == j;
    live = fi == 1 || fj == 1 || (diag && fi == 0);
    zero = diag && fi >= 0;
    const int xi = x_of(pki), yi = y_of(pki);
    xj = x_of(pkj);
    yj = y_of(pkj);
    rx = A + xi * lda;
    ry = A + yi * lda;
    if constexpr (kByes) {
      ok0 = live && xi < w && xj < w;
      ok1 = live && xi < w && yj < w;
      ok2 = live && yi < w && xj < w;
      ok3 = live && yi < w && yj < w;
    } else {
      ok0 = ok1 = ok2 = ok3 = live;
    }
    e00 = ok0 ? rx[xj] : T(0);
    e01 = ok1 ? rx[yj] : T(0);
    e10 = ok2 ? ry[xj] : T(0);
    e11 = ok3 ? ry[yj] : T(0);
  }

  __device__ __forceinline__ void rows(T ci, T si) {
    const T y00 = sub(mul(ci, e00), mul(si, e10));
    const T y10 = add(mul(si, e00), mul(ci, e10));
    const T y01 = sub(mul(ci, e01), mul(si, e11));
    const T y11 = add(mul(si, e01), mul(ci, e11));
    e00 = y00;
    e10 = y10;
    e01 = y01;
    e11 = y11;
  }

  __device__ __forceinline__ void columns(T cj, T sj) {
    const T y00 = sub(mul(cj, e00), mul(sj, e01));
    const T y01 = add(mul(sj, e00), mul(cj, e01));
    const T y10 = sub(mul(cj, e10), mul(sj, e11));
    const T y11 = add(mul(sj, e10), mul(cj, e11));
    e00 = y00;
    e01 = y01;
    e10 = y10;
    e11 = y11;
  }

  __device__ __forceinline__ void rotate(T ci, T si, T cj, T sj) {
    if (fi == 1) rows(ci, si);
    if (fj == 1) columns(cj, sj);
    if (zero) {  // a_pq = a_qp = 0 on a diagonal tile
      e01 = T(0);
      e10 = T(0);
    }
  }

  __device__ __forceinline__ void store() const {
    if (ok0) rx[xj] = e00;
    if (ok1) rx[yj] = e01;
    if (ok2) ry[xj] = e10;
    if (ok3) ry[yj] = e11;
  }
};

// The rotation of pair i of set r: (c, signed s) and the packed pair.
template <typename T>
__device__ __forceinline__ int pair_rotation(const T* A, int lda, int w,
                                             int W, int i, int r,
                                             typename Vec2<T>::type& cs) {
  const int x = i == 0 ? 0 : 1 + (i - 1 + r) % (W - 1);
  const int y = 1 + (W - 2 - i + r) % (W - 1);
  const int p = min(x, y), q = max(x, y);
  T c = T(1), s = T(0);
  int f = -1;
  if (q < w) {
    const T app = A[p * lda + p], aqq = A[q * lda + q];
    const T apq = A[p * lda + q];
    const T thr = mul(machine_eps<T>(), sqrt_rn(fabs(mul(app, aqq))));
    f = 0;
    if (fabs(apq) > thr) {
      const T tau = div(sub(aqq, app), mul(T(2), apq));
      const T sg = tau >= T(0) ? T(1) : T(-1);
      const T t = div(sg, add(fabs(tau), sqrt_rn(add(T(1), mul(tau, tau)))));
      c = div(T(1), sqrt_rn(add(T(1), mul(t, t))));
      s = mul(t, c);
      f = 1;
    }
  }
  cs.x = c;
  cs.y = x < y ? s : -s;  // the signed sine
  return pack(x, y, f);
}

template <typename T, int WC>
__device__ __forceinline__ void chain_cta(
    const T* __restrict__ a, int m, int w_arg, int max_sweeps,
    T* __restrict__ values, int* __restrict__ counts, T* __restrict__ work,
    unsigned char* smem, const Layout& L, cg::cluster_group& cluster,
    size_t blk) {
  using V2 = typename Vec2<T>::type;
  const int w = WC ? WC : w_arg;
  const int W = w + (w & 1), P = W / 2, S = W - 1;
  const int lda = w + 1;
  const int tid = threadIdx.x;
  const Table<T> tab(smem, P);
  unsigned long long* freed =
      reinterpret_cast<unsigned long long*>(smem + L.table);
  T* A = (WC || L.a_res) ? reinterpret_cast<T*>(smem + L.table + L.ring * 8)
                         : work + blk * w * lda;
  // CTA 1's "slot full" barriers, at this offset there
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(smem + L.ring * L.table);

  const T* ab = a + blk * w * w;
  for (int idx = tid; idx < w * w; idx += kThreads) {
    const int r = idx / w, c = idx - r * w;
    A[r * lda + c] = ab[idx];
  }
  if (tid == 0) {
    for (int k = 0; k < L.ring; ++k) bar_init(freed + k, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();

  int sweeps = 0, total = 0;
  unsigned g = 0;  // sets sent so far
  EK_PROBE_BEGIN();
  while (sweeps < max_sweeps) {
    ++sweeps;
    int in_sweep = 0;
    for (int r = 0; r < S; ++r, ++g) {
      // the set's rotations, a thread a pair (or several, at w > 2
      // kThreads), each sent into CTA 1's ring once it has freed the
      // slot: two asynchronous stores that complete on the slot's barrier
      // there
      int mine = 0;  // rotations of this thread's pairs
      if (tid < P) {
        const int slot = g % L.ring;
        bar_wait(freed + slot, ((g / L.ring) & 1) ^ 1);
        const Table<T> out(smem + slot * L.table, P);
        const unsigned bar = remote(full + slot, 1);
        for (int i = tid; i < P; i += kThreads) {
          V2 cs;
          const int pk = pair_rotation(A, lda, w, W, i, r, cs);
          mine += flag_of(pk) == 1;
          tab.cs[i] = cs;
          tab.pk[i] = pk;
          st_async(remote(out.cs + i, 1), cs, bar);
          st_async(remote(out.pk + i, 1), pk, bar);
        }
      }
      EK_PROBE_ARRIVE();
      // the set's rotations, a barrier for each bit of a thread's count
      int nrot = __syncthreads_count(mine & 1);
      for (int bit = 1; (1 << bit) <= (P + kThreads - 1) / kThreads; ++bit)
        nrot += __syncthreads_count((mine >> bit) & 1) << bit;
      EK_PROBE(0);
      in_sweep += nrot;
      // rows then columns of A, a 2 x 2 tile at a time
      if constexpr (WC != 0) {
        // a thread's column pair j is fixed; its row pairs are i0 +
        // kStride n; four tiles loaded before any is stored
        constexpr int PC = WC / 2, kStride = kThreads / PC;
        constexpr int kTiles = PC / kStride, kBatch = 4;
        static_assert(kThreads % PC == 0 && kTiles % kBatch == 0,
                      "a thread keeps one column pair");
        const int j = tid % PC, i0 = tid / PC;
        const int pkj = tab.pk[j];
        const V2 csj = tab.cs[j];
#pragma unroll
        for (int n0 = 0; n0 < kTiles; n0 += kBatch) {
          Tile<T, false> t[kBatch];
          V2 csi[kBatch];
          bool all_rows = true;  // the same on the warp: i is
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int ti = i0 + (n0 + u) * kStride;
            csi[u] = tab.cs[ti];
            t[u].load(A, lda, w, ti, j, tab.pk[ti], pkj);
            all_rows = all_rows && t[u].fi == 1;
          }
          // one branch for the batch where it can be, so that the four
          // tiles' products interleave
          if (all_rows) {
#pragma unroll
            for (int u = 0; u < kBatch; ++u) t[u].rows(csi[u].x, csi[u].y);
          } else {
#pragma unroll
            for (int u = 0; u < kBatch; ++u)
              if (t[u].fi == 1) t[u].rows(csi[u].x, csi[u].y);
          }
          if (flag_of(pkj) == 1) {
#pragma unroll
            for (int u = 0; u < kBatch; ++u) t[u].columns(csj.x, csj.y);
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (t[u].zero) {  // a_pq = a_qp = 0 on a diagonal tile
              t[u].e01 = T(0);
              t[u].e10 = T(0);
            }
            t[u].store();
          }
        }
      } else {
        for (int n = tid; n < P * P; n += kThreads) {
          const int ti = n / P, j = n - ti * P;
          const V2 csi = tab.cs[ti], csj = tab.cs[j];
          Tile<T, true> t;
          t.load(A, lda, w, ti, j, tab.pk[ti], tab.pk[j]);
          t.rotate(csi.x, csi.y, csj.x, csj.y);
          t.store();
        }
      }
      EK_PROBE_ARRIVE();
      __syncthreads();
      EK_PROBE(1);
    }
    total += in_sweep;
    if (in_sweep == 0) break;
  }
  EK_PROBE_END(g);

  for (int k = tid; k < w; k += kThreads)
    values[blk * w + k] = A[k * lda + k];
  if (tid == 0) {
    counts[blk] = sweeps;
    counts[m + blk] = total;
  }
}

// --- CTA 1: V^T -----------------------------------------------------------

// Rows x, y of V^T at column k by pair i of the table, if it rotates (the
// signed sine, as the tiles); load() and apply() apart, as the tiles'.
template <typename T>
struct VRow {
  T* vx;
  T* vy;
  bool live;
  T a, b;
  typename Vec2<T>::type cs;

  __device__ __forceinline__ void load(T* V, int w, int k, const Table<T>& t,
                                       int i) {
    const int pk = t.pk[i];
    live = flag_of(pk) == 1;
    vx = V + x_of(pk) * w + k;
    vy = V + y_of(pk) * w + k;
    if (live) {
      cs = t.cs[i];
      a = *vx;
      b = *vy;
    }
  }
  __device__ __forceinline__ void rotate() const {
    *vx = sub(mul(cs.x, a), mul(cs.y, b));
    *vy = add(mul(cs.y, a), mul(cs.x, b));
  }
  __device__ __forceinline__ void apply() const {
    if (live) rotate();
  }
};

template <typename T, int WC>
__device__ __forceinline__ void vector_cta(int w_arg, int max_sweeps,
                                           T* __restrict__ vt,
                                           unsigned char* smem,
                                           const Layout& L,
                                           cg::cluster_group& cluster,
                                           size_t blk) {
  using V2 = typename Vec2<T>::type;
  const int w = WC ? WC : w_arg;
  const int W = w + (w & 1), P = W / 2, S = W - 1;
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(smem + L.ring * L.table);
  // CTA 0's "slot free" barriers, at this offset there
  unsigned long long* freed =
      reinterpret_cast<unsigned long long*>(smem + L.table);
  T* V = (WC || L.v_res) ? reinterpret_cast<T*>(smem + L.ring * (L.table + 8))
                         : vt + blk * w * w;

  for (int idx = threadIdx.x; idx < w * w; idx += kThreads) {
    const int r = idx / w, c = idx - r * w;
    V[idx] = r == c ? T(1) : T(0);
  }
  if (threadIdx.x == 0) {
    for (int k = 0; k < L.ring; ++k) {
      bar_init(full + k, 1);
      bar_expect(full + k, L.bytes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();

  int sweeps = 0;
  unsigned g = 0;
  EK_PROBE_BEGIN();
  while (sweeps < max_sweeps) {
    ++sweeps;
    int any_in_sweep = 0;
    for (int r = 0; r < S; ++r, ++g) {
      const int slot = g % L.ring;
      bar_wait(full + slot, (g / L.ring) & 1);
      EK_PROBE_MARK(0);
      const Table<T> tab(smem + slot * L.table, P);
      int mine = 0;
      if constexpr (WC != 0) {
        // a thread's column k is fixed, its pairs are i0 + kStride * n;
        // four pairs loaded before any is stored
        constexpr int kStride = kThreads / WC, kItems = WC / 2 / kStride;
        constexpr int kBatch = 4;
        static_assert(kThreads % WC == 0 && kItems % kBatch == 0,
                      "a thread keeps one column");
        const int k = threadIdx.x % WC, i0 = threadIdx.x / WC;
#pragma unroll
        for (int n0 = 0; n0 < kItems; n0 += kBatch) {
          VRow<T> v[kBatch];
          bool all = true;  // the same on the warp: the pairs are
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            v[u].load(V, w, k, tab, i0 + (n0 + u) * kStride);
            mine |= v[u].live;
            all = all && v[u].live;
          }
          if (all) {
#pragma unroll
            for (int u = 0; u < kBatch; ++u) v[u].rotate();
          } else {
#pragma unroll
            for (int u = 0; u < kBatch; ++u) v[u].apply();
          }
        }
      } else {
        for (int idx = threadIdx.x; idx < P * w; idx += kThreads) {
          const int i = idx / w, k = idx - i * w;
          VRow<T> v;
          v.load(V, w, k, tab, i);
          mine |= v.live;
          v.apply();
        }
      }
      EK_PROBE_ARRIVE();
      // every thread is done with the slot and with this set's rows
      any_in_sweep |= __syncthreads_or(mine);
      EK_PROBE(1);
      if (threadIdx.x == 0) {
        bar_expect(full + slot, L.bytes);  // its next use
        bar_arrive_remote(freed + slot, 0);
      }
    }
    if (!any_in_sweep) break;
  }
  EK_PROBE_END(g);

  if (WC || L.v_res) {
    T* out = vt + blk * w * w;
    for (int idx = threadIdx.x; idx < w * w; idx += kThreads)
      out[idx] = V[idx];
  }
}

template <typename T, int WC>
__global__ void __launch_bounds__(kThreads)
    pair_jacobi_kernel(const T* __restrict__ a, int m, int w,
                       int max_sweeps, T* __restrict__ values,
                       T* __restrict__ vt, int* __restrict__ counts,
                       T* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Layout L = layout(WC ? WC : w, sizeof(T));
  const size_t blk = blockIdx.x / 2;
  if (cluster.block_rank() == 0)
    chain_cta<T, WC>(a, m, w, max_sweeps, values, counts, work, smem, L,
                     cluster, blk);
  else
    vector_cta<T, WC>(w, max_sweeps, vt, smem, L, cluster, blk);
  // neither CTA leaves while the other may still reach its shared memory
  cluster.sync();
}

template <typename T, int WC>
cudaError_t launch_as(const T* a, int m, int w, int max_sweeps, T* values,
                      T* vt, int* counts, T* work, int smem,
                      cudaStream_t stream) {
  auto kernel = pair_jacobi_kernel<T, WC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * m);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a, m, w, max_sweeps, values, vt,
                           counts, work);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int launch(const void* a, int m, int w, int max_sweeps, void* values,
           void* vt, void* counts, void* work, void* stream) {
  if (m < 1 || w < 1 || w > kMaxWidth || max_sweeps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = layout(w, sizeof(T));
  if (L.ring < 1 || (!L.a_res && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* ap = static_cast<const T*>(a);
  T* vp = static_cast<T*>(values);
  T* vtp = static_cast<T*>(vt);
  int* cp = static_cast<int*>(counts);
  T* wp = static_cast<T*>(work);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      w == kFixedWidth && L.a_res && L.v_res
          ? launch_as<T, kFixedWidth>(ap, m, w, max_sweeps, vp, vtp, cp, wp,
                                      L.smem, st)
          : launch_as<T, 0>(ap, m, w, max_sweeps, vp, vtp, cp, wp, L.smem,
                            st);
  return static_cast<int>(err);
}

}  // namespace

// a: (m, w, w) symmetric blocks, contiguous; values: (m, w); vt: (m, w, w),
// V^T of each block; counts: (2, m) int32, the sweeps and the rotations of
// each block; work: (m, w, w + 1) scratch where the block does not fit in
// shared memory (ek_pair_jacobi_resident bit 0 clear), else unused.
// w <= 32767, and a set's table fits the shared memory (w <= 23242 in
// float64).  Returns the launch's error (cudaErrorInvalidValue for a width
// it does not take), else cudaGetLastError().
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

// The dynamic shared memory of each CTA of a launch at width w, item size
// isz (both CTAs launch with the larger).
extern "C" int ek_pair_jacobi_smem(int w, int isz) {
  return layout(w, isz).smem;
}

// Bit 0: the block lives in CTA 0's shared memory; bit 1: V^T in CTA 1's.
extern "C" int ek_pair_jacobi_resident(int w, int isz) {
  const Layout L = layout(w, isz);
  return L.a_res | (L.v_res << 1);
}
