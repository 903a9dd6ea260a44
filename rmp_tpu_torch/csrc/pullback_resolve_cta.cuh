// K1 at n = 33..64: fused RMP pullback + pivoted-LU resolve, a CTA of four
// warps per environment, [A | f] in shared memory.
//
// Replaces, with the lane kernel (pullback_resolve.cu, n <= 9) and the warp
// kernel (pullback_resolve_wide.cuh, n = 10..32), the TPU kernel
// rmp_tpu/ops/pallas_resolve.py::pullback_resolve_structured
// (_kernel_structured, _lu_solve_lanes). It computes what the warp kernel
// computes (pullback_resolve_wide.cuh:1-13): per env b
//   A = sum_identity M + sum_dense J^T W + sum_scalar J^T diag(m) J
//   f = sum_identity v + sum_dense J^T v + sum_scalar J^T v
// plus ridge I, then Gaussian elimination with the reference's partial
// pivoting (a row takes the pivot only where its |a_ik| is STRICTLY above
// every magnitude of rows k..i-1, NaN-propagating; the displaced candidate
// moves into the taking row) and safe_denom clamps (|pivot|, |diagonal| >=
// 1e-12, sign kept), then back substitution to q̈ (B, n). It reads the same
// descriptor table (pullback_resolve.cuh). Plain version:
// ops/cuda_resolve.pullback_resolve_structured_plain.
//
// Why a CTA: at n = 64, [A | f] is 64 x 65 floats (16.6 KB), more than a
// warp's registers hold (the warp kernel keeps a row a lane, n <= 32).
//
// Bound on an H100 SXM (3.35 TB/s): bytes. The 64-link planar arm's tick
// (two 64 x 64 identity metrics, a scalar block of 65 rows, a dense block
// of 3) moves about 52 KB an env, ~0.06 ms at B = 4096.
//
// Design (a plain kernel, right first; speed is later work).
// - One CTA of 128 threads per env; n is a run-time value masked inside the
//   instantiation kMaxN = 48 or 64, so the file builds two kernels.
// - The scalar and dense blocks stream through a ring of two stages of
//   shared memory, a chunk of rows at a time, staged by cp.async (float32;
//   a bfloat16 element is widened through a register) with the threads
//   along whichever of a tensor's row and column axes is contiguous. A
//   staged row holds J with v at column n (scalar: m beside), and a dense
//   block's W with v at column n, as in the warp kernel.
// - Each of 8 x 13 threads keeps an a x b tile of [A | f] in registers
//   (a = kMaxN / 8 rows, b columns) over every staged row; the tiles then
//   go to shared memory as [A | f] (over the ring), and the identity blocks
//   are added there entry by entry, read along their contiguous axis.
// - Elimination: rows stay in place behind a permutation kept as indices
//   (`who`: the physical row at each logical position), every warp holding
//   the same copy in registers (positions lane and lane + 32). At column k
//   each warp finds the chain of rows that take the pivot by ballots over
//   the magnitudes in logical order (each record, the strict prefix
//   maximum, with NaN ending the chain) and rotates `who` along it; then the
//   four warps split the rows not yet a pivot, the lanes their columns, and
//   each subtracts factor x pivot row as a product and then a difference,
//   rounded apart as the plain version's elementwise operations are. One
//   __syncthreads a column.
// - Back substitution by columns on one warp: x_i is broadcast and every
//   unsolved row subtracts a_ri x_i; q̈_i is stored by the lane that holds
//   logical row i.
#pragma once

#include <cuda_runtime.h>

#include "pullback_resolve.cuh"

namespace rmp_k1 {
namespace cta {

constexpr int kThreads = 128;        // four warps, one env
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 8;         // row tiles of [A | f]
constexpr unsigned kAll = 0xffffffffu;

// The shape of the instantiation at kMaxN: tiles of a x b entries on TR x TC
// threads, row pitch P (odd, and no tile reads past a row), the ring's two
// stages over the P * kMaxN floats of [A | f], and the rows a stage holds.
template <int kMaxN>
struct Shape {
  static_assert(kMaxN % kTileRows == 0 && kMaxN <= 64, "two rows a lane");
  static constexpr int a = kMaxN / kTileRows;
  static constexpr int b = (kMaxN + 1 + 15) / 16;
  static constexpr int tc = (kMaxN + 1 + b - 1) / b;
  static constexpr int tiles = kTileRows * tc;
  static constexpr int P = (b * tc > kMaxN + 1 ? b * tc : kMaxN + 1) | 1;
  static constexpr int floats = kMaxN * P;
  static constexpr int stage = floats / 2;
  static constexpr int cap(int r) { return r > 32 ? 32 : r; }
  static constexpr int scalar_rows = cap(stage / (P + 1));
  static constexpr int dense_rows = cap(stage / (2 * P));
  static_assert(tiles <= kThreads && dense_rows >= 1, "a tile a thread");
};

// Rows r0..r0+nr-1, columns 0..n-1 of a block tensor (element type T) into
// dst at pitch P, the threads along its contiguous axis.
template <class T>
__device__ __forceinline__ void stage_matrix(float* dst, int P, const void* p,
                                             const long long* s, long long b,
                                             int r0, int nr, int n, int tid) {
  const T* base = static_cast<const T*>(p) + b * s[0] + r0 * s[1];
  const long long srow = s[1] < 0 ? -s[1] : s[1];
  const long long scol = s[2] < 0 ? -s[2] : s[2];
  const int total = nr * n;
  if (srow <= scol) {
    for (int e = tid; e < total; e += kThreads) {
      const int c = e / nr, i = e - c * nr;
      copy(dst + i * P + c, base + i * s[1] + c * s[2]);
    }
  } else {
    for (int e = tid; e < total; e += kThreads) {
      const int i = e / n, c = e - i * n;
      copy(dst + i * P + c, base + i * s[1] + c * s[2]);
    }
  }
}

// Entries r0..r0+nr-1 of a (B, R) block tensor into dst[i step].
template <class T>
__device__ __forceinline__ void stage_vector(float* dst, int step,
                                             const void* p,
                                             const long long* s, long long b,
                                             int r0, int nr, int tid) {
  const T* base = static_cast<const T*>(p) + b * s[0] + r0 * s[1];
  for (int e = tid; e < nr; e += kThreads) copy(dst + e * step, base + e * s[1]);
}

// A chunk of a scalar or dense block (rows r0.., nr of them) into a stage.
template <int kMaxN, class T>
__device__ __forceinline__ void stage_chunk(float* st, const Block& blk,
                                            long long b, int r0, int nr,
                                            int n, int tid) {
  using S = Shape<kMaxN>;
  stage_matrix<T>(st, S::P, blk.ptr[0], blk.stride[0], b, r0, nr, n, tid);
  if (blk.kind == kScalar) {
    stage_vector<T>(st + n, S::P, blk.ptr[2], blk.stride[2], b, r0, nr, tid);
    stage_vector<T>(st + S::scalar_rows * S::P, 1, blk.ptr[1], blk.stride[1],
                    b, r0, nr, tid);
  } else {
    float* w = st + S::dense_rows * S::P;
    stage_matrix<T>(w, S::P, blk.ptr[1], blk.stride[1], b, r0, nr, n, tid);
    stage_vector<T>(w + n, S::P, blk.ptr[2], blk.stride[2], b, r0, nr, tid);
  }
}

template <int kMaxN>
__device__ __forceinline__ int chunk_of(const Block& blk) {
  return blk.kind == kScalar ? Shape<kMaxN>::scalar_rows
                             : Shape<kMaxN>::dense_rows;
}

// The next chunk of rows in tag order, identity blocks skipped (they are
// added to [A | f] after the rows): block k from row r0; k == count at the
// end.
__device__ __forceinline__ void first_rows(const Table& table, int& k) {
  while (k < table.count && table.block[k].kind == kIdentity) ++k;
}
template <int kMaxN>
__device__ __forceinline__ void next_chunk(const Table& table, int& k,
                                           int& r0) {
  r0 += chunk_of<kMaxN>(table.block[k]);
  if (r0 >= table.block[k].rows) {
    ++k;
    r0 = 0;
    first_rows(table, k);
  }
}

template <int kMaxN>
__device__ __forceinline__ void stage_any(float* st, const Table& table,
                                          int k, int r0, long long b, int n,
                                          int tid) {
  const Block& blk = table.block[k];
  const int nr = min(chunk_of<kMaxN>(blk), blk.rows - r0);
  if (blk.elem == kBFloat16)
    stage_chunk<kMaxN, bf16_t>(st, blk, b, r0, nr, n, tid);
  else
    stage_chunk<kMaxN, float>(st, blk, b, r0, nr, n, tid);
}

template <int kMaxN>
__global__ void __launch_bounds__(kThreads)
    pullback_resolve_cta_kernel(int n, const __grid_constant__ Table table,
                                float ridge, float* __restrict__ out) {
  using S = Shape<kMaxN>;
  constexpr int P = S::P, A = S::a, Bt = S::b;
  __shared__ float smem[S::floats];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long b = blockIdx.x;

  // this thread's tile of [A | f]: rows ra.., columns cb..
  const bool active = tid < S::tiles;
  const int ra = A * (tid / S::tc), cb = Bt * (tid % S::tc);
  float acc[A][Bt];
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < Bt; ++j) acc[i][j] = 0.0f;

  // ---- the scalar and dense blocks' rows, chunk by chunk ----
  int ik = 0, ir0 = 0;  // the next chunk to stage
  first_rows(table, ik);
  if (ik < table.count) {
    stage_any<kMaxN>(smem, table, ik, ir0, b, n, tid);
    next_chunk<kMaxN>(table, ik, ir0);
  }
  cp_async_commit();
  int k = 0, r0 = 0, slot = 0;
  first_rows(table, k);
  while (k < table.count) {
    if (ik < table.count) {
      stage_any<kMaxN>(smem + (slot ^ 1) * S::stage, table, ik, ir0, b, n,
                       tid);
      next_chunk<kMaxN>(table, ik, ir0);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* st = smem + slot * S::stage;
    const Block& blk = table.block[k];
    const int nr = min(chunk_of<kMaxN>(blk), blk.rows - r0);
    if (active) {
      if (blk.kind == kScalar) {
        // row factors J[i][ra..], column factors m J[i][cb..] (v at n)
        const float* m = st + S::scalar_rows * P;
        for (int i = 0; i < nr; ++i) {
          const float mi = m[i];
          float u[A];
#pragma unroll
          for (int q = 0; q < A; ++q) u[q] = st[i * P + ra + q];
#pragma unroll
          for (int j = 0; j < Bt; ++j) {
            const float x = st[i * P + cb + j];
            const float v = cb + j == n ? x : mi * x;
#pragma unroll
            for (int q = 0; q < A; ++q) acc[q][j] += u[q] * v;
          }
        }
      } else {
        // row factors J[i][ra..], column factors W[i][cb..] (v at n)
        const float* w = st + S::dense_rows * P;
        for (int i = 0; i < nr; ++i) {
          float u[A];
#pragma unroll
          for (int q = 0; q < A; ++q) u[q] = st[i * P + ra + q];
#pragma unroll
          for (int j = 0; j < Bt; ++j) {
            const float v = w[i * P + cb + j];
#pragma unroll
            for (int q = 0; q < A; ++q) acc[q][j] += u[q] * v;
          }
        }
      }
    }
    __syncthreads();  // the stage is free for the chunk after next
    next_chunk<kMaxN>(table, k, r0);
    slot ^= 1;
  }
  cp_async_wait<0>();
  __syncthreads();

  // ---- the tiles into [A | f] (over the ring) ----
  float* sA = smem;
  if (active) {
#pragma unroll
    for (int i = 0; i < A; ++i) {
      if (ra + i >= n) continue;
#pragma unroll
      for (int j = 0; j < Bt; ++j)
        if (cb + j <= n) sA[(ra + i) * P + cb + j] = acc[i][j];
    }
  }
  __syncthreads();

  // ---- the identity blocks, entry by entry along the contiguous axis ----
  for (int kb = 0; kb < table.count; ++kb) {
    const Block& blk = table.block[kb];
    if (blk.kind != kIdentity) continue;
    const long long* s = blk.stride[0];
    const bool rows_fast =
        (s[1] < 0 ? -s[1] : s[1]) <= (s[2] < 0 ? -s[2] : s[2]);
    for (int e = tid; e < n * n; e += kThreads) {
      const int hi = e / n, lo = e - hi * n;
      const int i = rows_fast ? lo : hi, c = rows_fast ? hi : lo;
      sA[i * P + c] += at(blk.ptr[0], blk.elem, s, b, i, c);
    }
    for (int e = tid; e < n; e += kThreads)
      sA[e * P + n] += at(blk.ptr[1], blk.elem, blk.stride[1], b, e, 0);
    __syncthreads();
  }
  if (tid < n) sA[tid * P + tid] += ridge;
  __syncthreads();

  // ---- elimination ----
  // who[s]: the physical row at logical position lane + 32 s (every warp
  // keeps the same copy)
  int who[2] = {lane, lane + 32};
  for (int kk = 0; kk < n; ++kk) {
    // column kk in logical order; the records after kk: each magnitude
    // strictly above every one before it, none after the first NaN
    float val[2], mag[2];
    bool in[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int p = lane + 32 * s;
      val[s] = p < n ? sA[who[s] * P + kk] : 0.0f;
      mag[s] = fabsf(val[s]);
      in[s] = p > kk && p < n;
    }
    const int kl = kk & 31;
    float cur = kk < 32 ? __shfl_sync(kAll, mag[0], kl)
                        : __shfl_sync(kAll, mag[1], kl);
    int last = kk;
    unsigned long long takes = 0ull;
    if (cur == cur) {
      unsigned long long next =
          __ballot_sync(kAll, in[0] && !(mag[0] <= cur)) |
          (static_cast<unsigned long long>(
               __ballot_sync(kAll, in[1] && !(mag[1] <= cur)))
           << 32);
      while (next) {
        const int i = __ffsll(static_cast<long long>(next)) - 1;
        const float m = i < 32 ? __shfl_sync(kAll, mag[0], i & 31)
                               : __shfl_sync(kAll, mag[1], i & 31);
        if (m != m) break;
        last = i;
        takes |= 1ull << i;
        cur = m;
        const unsigned long long above =
            __ballot_sync(kAll, !(mag[0] <= cur)) |
            (static_cast<unsigned long long>(
                 __ballot_sync(kAll, !(mag[1] <= cur)))
             << 32);
        next &= above & ~((2ull << i) - 1ull);
      }
    }
    // the pivot: the last record's row and value; the chain kk -> i1 ->
    // ... -> im: logical kk takes im's row, each taker the row of the
    // taker before it (kk's for the first)
    const int ll = last & 31;
    const int piv = last < 32 ? __shfl_sync(kAll, who[0], ll)
                              : __shfl_sync(kAll, who[1], ll);
    const float pv = last < 32 ? __shfl_sync(kAll, val[0], ll)
                               : __shfl_sync(kAll, val[1], ll);
    int moved[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int p = lane + 32 * s;
      const unsigned long long below = takes & ((1ull << p) - 1ull);
      const int src = ((takes >> p) & 1ull)
                          ? (below ? 63 - __clzll(static_cast<long long>(
                                              below))
                                   : kk)
                          : (p == kk ? last : p);
      const int w0 = __shfl_sync(kAll, who[0], src & 31);
      const int w1 = __shfl_sync(kAll, who[1], src & 31);
      moved[s] = src < 32 ? w0 : w1;
    }
    who[0] = moved[0];
    who[1] = moved[1];
    const float inv = __frcp_rn(clamp_ref(pv));
    // rows at logical kk+1.. (warp by warp) subtract factor x the pivot row
    // (columns kk+1..n, lane by lane), a product and then a difference as
    // the reference rounds
    float pc[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int c = kk + 1 + lane + 32 * j;
      pc[j] = c <= n ? sA[piv * P + c] : 0.0f;
    }
    for (int p = kk + 1 + warp; p < n; p += kWarps) {
      const int r = p < 32 ? __shfl_sync(kAll, who[0], p & 31)
                           : __shfl_sync(kAll, who[1], p & 31);
      const float factor = __fmul_rn(sA[r * P + kk], inv);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int c = kk + 1 + lane + 32 * j;
        if (c <= n)
          sA[r * P + c] = __fsub_rn(sA[r * P + c], __fmul_rn(factor, pc[j]));
      }
    }
    __syncthreads();
  }

  // ---- back substitution, by columns, on warp 0 ----
  if (warp != 0) return;
  float rhs[2], diag[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int p = lane + 32 * s;
    rhs[s] = p < n ? sA[who[s] * P + n] : 0.0f;
    diag[s] = p < n ? sA[who[s] * P + p] : 1.0f;
  }
  for (int i = n - 1; i >= 0; --i) {
    const bool lo = i < 32;
    const float mine = __fdiv_rn(lo ? rhs[0] : rhs[1],
                                 clamp_ref(lo ? diag[0] : diag[1]));
    const float xi = __shfl_sync(kAll, mine, i & 31);
    if (lane == (i & 31)) out[b * n + i] = xi;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int p = lane + 32 * s;
      if (p < i)
        rhs[s] = __fsub_rn(rhs[s], __fmul_rn(sA[who[s] * P + i], xi));
    }
  }
}

}  // namespace cta
}  // namespace rmp_k1
