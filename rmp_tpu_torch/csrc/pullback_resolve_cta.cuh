// K1 at n = 33..64: fused RMP pullback + pivoted-LU resolve, a warp per
// environment with the rows of [A | f] in registers, redesigned for the
// H100.
//
// Replaces, with the lane kernel (pullback_resolve.cu, n <= 9) and the warp
// kernel (pullback_resolve_wide.cuh, n = 10..32), the TPU kernel
// rmp_tpu/ops/pallas_resolve.py::pullback_resolve_structured
// (_kernel_structured, _lu_solve_lanes). Per env b:
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
// Bound on an H100 SXM (3.35 TB/s): bytes. The 64-link planar arm's tick
// (two 64 x 64 identity metrics, a scalar block of 65 rows, a dense block
// of 3) moves about 52 KB an env, ~0.064 ms at B = 4096.
//
// The design it replaces (a CTA of four warps an env, [A | f] in
// shared memory, the tiles' sums, then the identity blocks added entry by
// entry, and an elimination whose every column updated the rows in shared
// memory by read-modify-write behind a barrier) took 0.7153 ms at n = 64
// and 0.2618 ms at n = 33 on the arms' real ticks (B = 4096, H100 80GB
// HBM3, 700 W; PERF.md), 3.6x the warp kernel's n = 32 time for 6% more
// bytes. `kernel_probe.py k1cta --against DIR` splits that design.
//
// Design.
// - One warp an env, one warp a CTA (B CTAs). kMaxN = 40 (n = 33..40) or
//   64 (n = 41..64) is the instantiation, n at run time inside it: lane l
//   keeps physical rows l and l + 32 of [A + ridge I | f] in registers,
//   columns 0..kMaxN - 1 and f at kMaxN, for the whole solve. Columns
//   n..kMaxN - 1 are zero, and column work past n is skipped four or eight
//   columns at a time, so n = 48 costs about what a kMaxN of 48 would,
//   but for the envs an SM that 64 rows of registers allow.
// - Every block, identity blocks included, streams in tag order through a
//   ring of kStages stages of the warp's shared memory, a chunk of up to 16
//   rows (8 for a dense block) a stage, staged by cp.async along whichever
//   of a tensor's row and column axes is contiguous (16-byte copies where a
//   float32 row is contiguous and aligned; a bfloat16 element is widened
//   through a register), with no run-time integer division. Two chunks are
//   in flight while one is summed; the warp alone reads its ring (no
//   barrier wider than the warp).
// - A staged row holds J (scalar, dense) or M (identity) with v at column
//   kMaxN, a dense block's W likewise; its pitch P = kMaxN + 4 (P / 4 odd)
//   makes the lanes' float4 reads of their own rows conflict-free. A scalar
//   or dense row adds (m) J[i][l] x row i into lane l's rows, the row read
//   as float4 broadcasts; an identity chunk's rows go to the lanes that
//   hold them. (Register tiles of ta x tb entries a lane, with [A | f]
//   read back as rows through shared memory, took as long and spilled at
//   kMaxN = 64: the sums are not bound by the broadcasts' wavefronts.)
// - Elimination: rows never move. A permutation kept as indices (`who`:
//   the physical row at each logical position, lane l holding positions l
//   and l + 32) stands for the reference's row swaps: at column k the rows
//   that take the pivot are found by ballots over the magnitudes in logical
//   order (each record, the strict prefix maximum, with NaN ending the
//   chain), and `who` is rotated along the chain. The pivot row's lane
//   stores its two rows to shared memory as float4s, every lane reads the
//   pivot's back as float4 broadcasts, and every row not yet a pivot
//   (rows l + 32 skipped once all of them have been) subtracts factor x
//   pivot row as a product and then a difference, rounded apart as the
//   plain version's elementwise operations are (whole groups of eight
//   columns from the one that holds k + 1; a column at or left of k is
//   never read again). No barrier wider than the warp.
// - Back substitution by columns: x_k, from the lane that holds the row at
//   logical position k, goes to every lane, and every row whose position is
//   below k subtracts a_rk x_k (product, then difference); x_k is f over
//   the clamped diagonal, rounded as the plain version's division.
// - No call to a slow path of the IEEE reciprocal or division (a call
//   saves the rows' registers to local memory): both are correctly rounded
//   inline where the results are normal (rcp_rn, div_rn).
#pragma once

#include <cuda_runtime.h>

#include "pullback_resolve.cuh"
#include "whole_waves.cuh"

namespace rmp_k1 {
namespace cta {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kStages = 3;        // chunks in the ring: two in flight
constexpr int kChunk = 16;        // rows of a scalar or identity chunk
constexpr int kDenseChunk = 8;    // rows of a dense chunk (J, then W)

// The instantiation at kMaxN: the row pitch, a stage's floats (the rows,
// then a scalar chunk's m), the shared floats a CTA (the ring, then the
// pivot row and each physical row's clamped pivot and its reciprocal), the
// CTAs an SM that its registers allow (an SM's four schedulers hold 16
// warps at 128 registers, 12 at 168: at B = 4096, two whole waves at 40,
// three at 64), and the column groups that every n it takes fills (n > 32
// at 40, n > 40 at 64): their checks against n fold away.
template <int kMaxN>
struct Shape {
  static_assert(kMaxN == 40 || kMaxN == 64, "two instantiations");
  static constexpr int P = kMaxN + 4;
  static constexpr int stage = kChunk * P + kChunk;
  static constexpr int prow = kStages * stage;   // the pivot lane's rows
  static constexpr int pivots = prow + 2 * P;    // clamped pivots, 1 / them
  static constexpr int floats = pivots + 2 * 64;
  static constexpr int ctas = kMaxN == 40 ? 16 : 12;
  static constexpr int least_n = kMaxN == 40 ? 33 : 41;
};

// c ? a : b, in a form the compiler cannot turn back into a choice between
// the two rows' arrays (or an entry chosen at run time): that moves the
// rows out of registers into local memory (a 328-byte stack frame at
// kMaxN = 40).
__device__ __forceinline__ float pick(bool c, float a, float b) {
  float r;
  asm("{\n .reg .pred p;\n setp.ne.b32 p, %3, 0;\n selp.f32 %0, %1, %2, p;\n}"
      : "=f"(r)
      : "f"(a), "f"(b), "r"(static_cast<int>(c)));
  return r;
}

// Columns kk + 1.. of row r (from the group of eight that holds kk + 1,
// groups past n skipped) and f into row's floats, as float4s.
template <int kMaxN>
__device__ __forceinline__ void put_row(float* row,
                                        const float (&r)[kMaxN + 1], int kk,
                                        int n) {
#pragma unroll
  for (int g = 0; g < kMaxN; g += 8) {
    if (g + 8 <= kk + 1 || (g >= Shape<kMaxN>::least_n && g >= n)) continue;
    *reinterpret_cast<float4*>(row + g) =
        make_float4(r[g], r[g + 1], r[g + 2], r[g + 3]);
    *reinterpret_cast<float4*>(row + g + 4) =
        make_float4(r[g + 4], r[g + 5], r[g + 6], r[g + 7]);
  }
  row[kMaxN] = r[kMaxN];
}

// 1/d rounded to nearest, as __frcp_rn rounds it, with no call to a slow
// path (a call would spill the rows held in registers): the approximation
// refined by one Newton step is correctly rounded where 1/d is normal,
// 2^-126 < |d| < 2^126. d here is a clamped pivot, |d| >= 1e-12 or NaN;
// past 2^126 the subnormal 1/d is rounded twice (through 4/d), and 1/inf
// is 0 with inf's sign.
__device__ __forceinline__ float rcp_refined(float d) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(d));
  return __fmaf_rn(__fmaf_rn(-d, y, 1.0f), y, y);
}
__device__ __forceinline__ float rcp_rn(float d) {
  const float a = fabsf(d);
  if (a < 8.50705917e37f) return rcp_refined(d);  // 2^126
  if (a == __int_as_float(0x7f800000)) return copysignf(0.0f, d);
  return __fmul_rn(rcp_refined(d * 0.25f), 0.25f);
}

// x / d, as __fdiv_rn rounds it where x / d and 1/d are normal, from r =
// rcp_rn(d): the quotient x r corrected by its residual; a zero, infinite
// or NaN x r is kept.
__device__ __forceinline__ float div_rn(float x, float d, float r) {
  const float q = __fmul_rn(x, r);
  if (q == 0.0f || !isfinite(q)) return q;
  return __fmaf_rn(__fmaf_rn(-d, q, x), r, q);
}

// 16 bytes into shared memory by cp.async (both addresses 16-byte aligned).
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// Rows r0..r0+nr-1, columns 0..n-1 of a block tensor (element type T,
// strides s) into dst at pitch P: lanes along its contiguous axis. With
// `vec` (float32, rows contiguous and 16-byte aligned, n % 4 == 0) a lane
// copies 16 bytes, half a warp a row. Each lane walks its elements by a
// pointer and a step, one at a time (no unrolling): the copies are issued
// while the rows of [A | f] fill the registers.
template <class T>
__device__ __forceinline__ void stage_matrix(float* dst, int P, const void* p,
                                             const long long* s, long long b,
                                             int r0, int nr, int n, bool vec,
                                             int lane) {
  const T* base = static_cast<const T*>(p) + b * s[0] + r0 * s[1];
  const long long srow = s[1] < 0 ? -s[1] : s[1];
  const long long scol = s[2] < 0 ? -s[2] : s[2];
  if (srow <= scol) {
    // lanes along the rows: row lane % 16, columns lane / 16, + 2, ...
    const int i = lane & 15;
    if (i >= nr) return;
    const T* src = base + i * s[1] + (lane >> 4) * s[2];
    const long long step = 2 * s[2];
    float* d = dst + i * P + (lane >> 4);
#pragma unroll 1
    for (int c = lane >> 4; c < n; c += 2, src += step, d += 2) copy(d, src);
  } else if (vec) {
    const int c = 4 * (lane & 15);
    if (c >= n) return;
    const float* src =
        reinterpret_cast<const float*>(base + (lane >> 4) * s[1] + c);
    const long long step = 2 * s[1];
    float* d = dst + (lane >> 4) * P + c;
#pragma unroll 1
    for (int i = lane >> 4; i < nr; i += 2, src += step, d += 2 * P)
      cp_async16(d, src);
  } else {
#pragma unroll 1
    for (int i = 0; i < nr; ++i) {
      const T* src = base + i * s[1] + lane * s[2];
      float* d = dst + i * P + lane;
#pragma unroll 1
      for (int c = lane; c < n; c += 32, src += 32 * s[2], d += 32)
        copy(d, src);
    }
  }
}

// Entries r0..r0+nr-1 of a (B, R) or (B, n) block tensor into dst[i step].
template <class T>
__device__ __forceinline__ void stage_vector(float* dst, int step,
                                             const void* p,
                                             const long long* s, long long b,
                                             int r0, int nr, int lane) {
  if (lane < nr)
    copy(dst + lane * step,
         static_cast<const T*>(p) + b * s[0] + (r0 + lane) * s[1]);
}

// Whether a float32 tensor's rows are contiguous and 16-byte aligned, so
// that a row of n floats copies as float4s.
__device__ __forceinline__ bool rows_vec(const void* p, const long long* s,
                                         int n) {
  return s[2] == 1 && s[1] % 4 == 0 && s[0] % 4 == 0 && n % 4 == 0 &&
         (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

// A chunk of block `blk` (rows r0.., nr of them) into the stage at `st`.
template <int kMaxN, class T>
__device__ __forceinline__ void stage_chunk(float* st, const Block& blk,
                                            long long b, int r0, int nr,
                                            int n, int lane) {
  constexpr int P = Shape<kMaxN>::P;
  const bool f32 = blk.elem == kFloat32;
  if (blk.kind == kIdentity) {
    stage_matrix<T>(st, P, blk.ptr[0], blk.stride[0], b, r0, nr, n,
                    f32 && rows_vec(blk.ptr[0], blk.stride[0], n), lane);
    stage_vector<T>(st + kMaxN, P, blk.ptr[1], blk.stride[1], b, r0, nr,
                    lane);
  } else if (blk.kind == kScalar) {
    stage_matrix<T>(st, P, blk.ptr[0], blk.stride[0], b, r0, nr, n,
                    f32 && rows_vec(blk.ptr[0], blk.stride[0], n), lane);
    stage_vector<T>(st + kMaxN, P, blk.ptr[2], blk.stride[2], b, r0, nr,
                    lane);
    stage_vector<T>(st + kChunk * P, 1, blk.ptr[1], blk.stride[1], b, r0, nr,
                    lane);
  } else {
    float* w = st + kDenseChunk * P;
    stage_matrix<T>(st, P, blk.ptr[0], blk.stride[0], b, r0, nr, n,
                    f32 && rows_vec(blk.ptr[0], blk.stride[0], n), lane);
    stage_matrix<T>(w, P, blk.ptr[1], blk.stride[1], b, r0, nr, n,
                    f32 && rows_vec(blk.ptr[1], blk.stride[1], n), lane);
    stage_vector<T>(w + kMaxN, P, blk.ptr[2], blk.stride[2], b, r0, nr,
                    lane);
  }
}

// Rows of a block and of a chunk of it, in tag order.
__device__ __forceinline__ int block_rows(const Block& blk, int n) {
  return blk.kind == kIdentity ? n : blk.rows;
}
__device__ __forceinline__ int chunk_of(const Block& blk) {
  return blk.kind == kDense ? kDenseChunk : kChunk;
}
__device__ __forceinline__ void next_chunk(const Table& table, int n, int& k,
                                           int& r0) {
  r0 += chunk_of(table.block[k]);
  if (r0 >= block_rows(table.block[k], n)) {
    ++k;
    r0 = 0;
  }
}

template <int kMaxN>
__device__ __forceinline__ void stage_next(float* st, const Table& table,
                                           long long b, int n, int& k,
                                           int& r0, int lane) {
  if (k >= table.count) return;
  const Block& blk = table.block[k];
  const int nr = min(chunk_of(blk), block_rows(blk, n) - r0);
  if (blk.elem == kBFloat16)
    stage_chunk<kMaxN, bf16_t>(st, blk, b, r0, nr, n, lane);
  else
    stage_chunk<kMaxN, float>(st, blk, b, r0, nr, n, lane);
  next_chunk(table, n, k, r0);
}

// Row i's columns 0..n-1 (as float4s, four at a time, groups past n
// skipped) times u0 and u1 into rows r0 and r1.
template <int kMaxN>
__device__ __forceinline__ void add_row(float (&r0)[kMaxN + 1],
                                        float (&r1)[kMaxN + 1],
                                        const float* row, float u0, float u1,
                                        int n) {
#pragma unroll
  for (int g = 0; g < kMaxN / 4; ++g) {
    if (4 * g >= Shape<kMaxN>::least_n && 4 * g >= n) break;
    const float4 x = *reinterpret_cast<const float4*>(row + 4 * g);
    r0[4 * g] += u0 * x.x;
    r0[4 * g + 1] += u0 * x.y;
    r0[4 * g + 2] += u0 * x.z;
    r0[4 * g + 3] += u0 * x.w;
    r1[4 * g] += u1 * x.x;
    r1[4 * g + 1] += u1 * x.y;
    r1[4 * g + 2] += u1 * x.z;
    r1[4 * g + 3] += u1 * x.w;
  }
}

// An identity chunk's row i (its columns and v at kMaxN) into row r.
template <int kMaxN>
__device__ __forceinline__ void add_identity_row(float (&r)[kMaxN + 1],
                                                 const float* row, int n) {
#pragma unroll
  for (int g = 0; g < kMaxN / 4; ++g) {
    if (4 * g >= Shape<kMaxN>::least_n && 4 * g >= n) break;
    const float4 x = *reinterpret_cast<const float4*>(row + 4 * g);
    r[4 * g] += x.x;
    r[4 * g + 1] += x.y;
    r[4 * g + 2] += x.z;
    r[4 * g + 3] += x.w;
  }
  r[kMaxN] += row[kMaxN];
}

// r0[c], r1[c] of the run-time column c (< kMaxN), read eight columns at a
// time: the group that holds c, then its entry.
template <int kMaxN>
__device__ __forceinline__ void column(const float (&r0)[kMaxN + 1],
                                       const float (&r1)[kMaxN + 1], int c,
                                       float& v0, float& v1) {
#pragma unroll
  for (int g = 0; g < kMaxN; g += 8) {
    if ((c & ~7) != g) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v0 = pick((c & 7) == j, r0[g + j], v0);
      v1 = pick((c & 7) == j, r1[g + j], v1);
    }
  }
}

template <int kMaxN>
__global__ void __launch_bounds__(32, Shape<kMaxN>::ctas)
    pullback_resolve_cta_kernel(int n, const __grid_constant__ Table table,
                                float ridge, float* __restrict__ out) {
  using S = Shape<kMaxN>;
  constexpr int P = S::P;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x;
  const long long b = blockIdx.x;

  // columns n..kMaxN-1 of every staged row stay zero: staging writes
  // columns 0..n-1 and kMaxN only
  for (int s = 0; s < kStages; ++s)
    for (int i = 0; i < kChunk; ++i)
      for (int c = n + lane; c < kMaxN; c += 32)
        ring[s * S::stage + i * P + c] = 0.0f;
  __syncwarp();

  // rows l and l + 32 of [A | f]
  float r0[kMaxN + 1], r1[kMaxN + 1];
#pragma unroll
  for (int c = 0; c <= kMaxN; ++c) r0[c] = r1[c] = 0.0f;
  const int hi = lane + 32 < kMaxN ? lane + 32 : kMaxN;  // row l + 32's column

  // ---- every block's rows, chunk by chunk through the ring ----
  int ik = 0, ir0 = 0;  // the next chunk to stage
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    stage_next<kMaxN>(ring + s * S::stage, table, b, n, ik, ir0, lane);
    cp_async_commit();
  }
  int k = 0, r0i = 0, slot = 0;
  while (k < table.count) {
    // the stage processed last round takes the chunk kStages - 1 ahead
    stage_next<kMaxN>(ring + (slot == 0 ? kStages - 1 : slot - 1) * S::stage,
                      table, b, n, ik, ir0, lane);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const float* st = ring + slot * S::stage;
    const Block& blk = table.block[k];
    const int nr = min(chunk_of(blk), block_rows(blk, n) - r0i);
    if (blk.kind == kIdentity) {
      // rows r0i.. (one slot's, r0i a multiple of 16) to the lanes that
      // hold them
      const int i = lane + (r0i >= 32 ? 32 : 0) - r0i;
      if (i >= 0 && i < nr) {
        if (r0i < 32)
          add_identity_row<kMaxN>(r0, st + i * P, n);
        else
          add_identity_row<kMaxN>(r1, st + i * P, n);
      }
    } else if (blk.kind == kScalar) {
      // row factors m J[i][l], m J[i][l + 32]; f: J[i][l] v, J[i][l + 32] v
#pragma unroll 1
      for (int i = 0; i < nr; ++i) {
        const float* row = st + i * P;
        const float m = st[kChunk * P + i], v = row[kMaxN];
        const float a0 = row[lane];
        const float a1 = lane + 32 < kMaxN ? row[hi] : 0.0f;
        add_row<kMaxN>(r0, r1, row, m * a0, m * a1, n);
        r0[kMaxN] += a0 * v;
        r1[kMaxN] += a1 * v;
      }
    } else {
      // row factors J[i][l], J[i][l + 32]; column factors W[i] (v at kMaxN)
#pragma unroll 1
      for (int i = 0; i < nr; ++i) {
        const float* row = st + i * P;
        const float* w = st + (kDenseChunk + i) * P;
        const float a0 = row[lane];
        const float a1 = lane + 32 < kMaxN ? row[hi] : 0.0f;
        add_row<kMaxN>(r0, r1, w, a0, a1, n);
        r0[kMaxN] += a0 * w[kMaxN];
        r1[kMaxN] += a1 * w[kMaxN];
      }
    }
    __syncwarp();  // the stage is free for the chunk kStages - 1 on
    next_chunk(table, n, k, r0i);
    slot = slot + 1 == kStages ? 0 : slot + 1;
  }
  cp_async_wait<0>();

  // ---- the ridge ----
  // + ridge I as the plain version adds it: ridge on the diagonal, 0 on
  // every other entry
  if (ridge != 0.0f) {
#pragma unroll
    for (int c = 0; c < kMaxN; ++c) {
      r0[c] += pick(c == lane, ridge, 0.0f);
      r1[c] += pick(c == lane + 32, ridge, 0.0f);
    }
  }

  // ---- elimination ----
  // who0, who1: the physical rows at logical positions l and l + 32; done:
  // the row has been a pivot (rows >= n from the start); pos, diag: where
  // it became the pivot, and its pivot entry; col: its entry in column kk
  int who0 = lane, who1 = lane + 32;
  bool done0 = lane >= n, done1 = lane + 32 >= n;
  int pos0 = 0, pos1 = 0;
  float* prow = ring + S::prow;
  float* sdiag = ring + S::pivots;    // by physical row
  float* sdinv = sdiag + 64;
  float col0 = r0[0], col1 = r1[0];
  for (int kk = 0; kk < n; ++kk) {
    // column kk in logical order; the records after kk: each magnitude
    // strictly above every one before it, none after the first NaN
    float val[2], mag[2];
    bool in[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int w = s == 0 ? who0 : who1;
      const float lo = __shfl_sync(kAll, col0, w & 31);
      const float up = __shfl_sync(kAll, col1, w & 31);
      const int p = lane + 32 * s;
      val[s] = p < n ? (w < 32 ? lo : up) : 0.0f;
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
    const int piv = last < 32 ? __shfl_sync(kAll, who0, ll)
                              : __shfl_sync(kAll, who1, ll);
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
      const int w0 = __shfl_sync(kAll, who0, src & 31);
      const int w1 = __shfl_sync(kAll, who1, src & 31);
      moved[s] = src < 32 ? w0 : w1;
    }
    who0 = moved[0];
    who1 = moved[1];
    // the pivot row keeps its clamped pivot and that pivot's reciprocal
    // for the back substitution, and goes to the warp through shared
    // memory (its lane's float4 stores, every lane's float4 broadcasts)
    const float dc = clamp_ref(pv);
    const float inv = rcp_rn(dc);
    __syncwarp();  // the last column's pivot row is read
    if (piv == lane) {
      done0 = true;
      pos0 = kk;
    }
    if (piv == lane + 32) {
      done1 = true;
      pos1 = kk;
    }
    // the pivot's lane stores both its rows (no choice between the two
    // arrays, which would move them to local memory); the warp reads the
    // pivot's
    if (lane == (piv & 31)) {
      put_row<kMaxN>(prow, r0, kk, n);
      put_row<kMaxN>(prow + P, r1, kk, n);
    }
    if (lane == 0) {
      sdiag[piv] = dc;
      sdinv[piv] = inv;
    }
    __syncwarp();
    // rows not yet a pivot subtract factor x the pivot row, a product and
    // then a difference as the reference rounds; eight columns at a time,
    // from the group that holds column kk + 1, groups past n skipped
    // (rows l + 32 skipped once every one of them has been a pivot)
    const float f0 = __fmul_rn(col0, inv), f1 = __fmul_rn(col1, inv);
    const float* pr = prow + (piv >= 32 ? P : 0);
    const bool any1 = __any_sync(kAll, !done1);
#pragma unroll
    for (int g = 0; g < kMaxN; g += 8) {
      if (g + 8 <= kk + 1 || (g >= S::least_n && g >= n)) continue;
      const float4 lo = *reinterpret_cast<const float4*>(pr + g);
      const float4 hi4 = *reinterpret_cast<const float4*>(pr + g + 4);
      const float pc[8] = {lo.x, lo.y, lo.z, lo.w, hi4.x, hi4.y, hi4.z, hi4.w};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (!done0) r0[g + j] = __fsub_rn(r0[g + j], __fmul_rn(f0, pc[j]));
      if (any1) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (!done1) r1[g + j] = __fsub_rn(r1[g + j], __fmul_rn(f1, pc[j]));
      }
    }
    {
      const float pc = pr[kMaxN];
      if (!done0) r0[kMaxN] = __fsub_rn(r0[kMaxN], __fmul_rn(f0, pc));
      if (!done1) r1[kMaxN] = __fsub_rn(r1[kMaxN], __fmul_rn(f1, pc));
    }
    if (kk + 1 < n) column<kMaxN>(r0, r1, kk + 1, col0, col1);
  }

  // ---- back substitution, by columns ----
  __syncwarp();  // every pivot's entries are in shared memory
  float x0 = 0.0f, x1 = 0.0f;  // q̈ at logical positions l and l + 32
#pragma unroll
  for (int g = kMaxN - 8; g >= 0; g -= 8) {
    if (g >= S::least_n && g >= n) continue;
#pragma unroll
    for (int j = 7; j >= 0; --j) {
      const int c = g + j;
      if (c >= S::least_n && c >= n) continue;
      const int p = c < 32 ? __shfl_sync(kAll, who0, c & 31)
                           : __shfl_sync(kAll, who1, c & 31);
      const float rhs =
          __shfl_sync(kAll, pick(p >= 32, r1[kMaxN], r0[kMaxN]), p & 31);
      const float x = div_rn(rhs, sdiag[p], sdinv[p]);
      if (lane == (c & 31)) {
        if (c < 32)
          x0 = x;
        else
          x1 = x;
      }
      if (!(lane >= n) && pos0 < c)
        r0[kMaxN] = __fsub_rn(r0[kMaxN], __fmul_rn(r0[c], x));
      if (!(lane + 32 >= n) && pos1 < c)
        r1[kMaxN] = __fsub_rn(r1[kMaxN], __fmul_rn(r1[c], x));
    }
  }
  if (lane < n) out[b * n + lane] = x0;
  if (lane + 32 < n) out[b * n + lane + 32] = x1;
}

// The dynamic shared memory a CTA of the instantiation asks for at B envs
// (whole waves), and the CTAs (envs) an SM holds at its own size: the
// occupancy is asked of the CUDA driver once per device.
template <int kMaxN>
void shape_at(int B, int& bytes, int& ctas) {
  constexpr int kDevices = 16;
  static int most[kDevices];  // CTAs an SM at the layout's own size
  bytes = Shape<kMaxN>::floats * 4;
  const rmp::SmShape d = rmp::current_sm_shape();
  ctas = 0;
  if (d.sms == 0 || d.device >= kDevices) return;
  if (most[d.device] == 0 &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &most[d.device], pullback_resolve_cta_kernel<kMaxN>, 32, bytes) !=
          cudaSuccess)
    most[d.device] = 0;
  ctas = most[d.device];
  bytes = rmp::whole_wave_bytes(bytes, ctas, B, d);
}

template <int kMaxN>
void launch(int n, int B, const Table& table, float ridge, float* out,
            cudaStream_t stream) {
  int bytes = 0, ctas = 0;
  shape_at<kMaxN>(B, bytes, ctas);
  if (bytes > 48 * 1024)  // above the default: opt in
    cudaFuncSetAttribute(pullback_resolve_cta_kernel<kMaxN>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  pullback_resolve_cta_kernel<kMaxN>
      <<<B, 32, bytes, stream>>>(n, table, ridge, out);
}

// The instantiation's shared bytes a CTA at B envs and the CTAs an SM holds
// at that size.
template <int kMaxN>
void residency(int B, int& bytes, int& ctas) {
  shape_at<kMaxN>(B, bytes, ctas);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &ctas, pullback_resolve_cta_kernel<kMaxN>, 32, bytes) !=
      cudaSuccess)
    ctas = 0;
}

}  // namespace cta
}  // namespace rmp_k1
