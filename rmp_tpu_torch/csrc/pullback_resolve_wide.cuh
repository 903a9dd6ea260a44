// K1 at n = 10..32: fused RMP pullback + pivoted-LU resolve, a warp per
// environment, redesigned for the H100.
//
// Replaces, with pullback_resolve.cu's lane kernel (n <= 9), the TPU kernel
// rmp_tpu/ops/pallas_resolve.py::pullback_resolve_structured
// (_kernel_structured, _lu_solve_lanes). Per env b:
//   A = sum_identity M + sum_dense J^T W + sum_scalar J^T diag(m) J
//   f = sum_identity v + sum_dense J^T v + sum_scalar J^T v
// plus ridge I, then Gaussian elimination with the reference's partial
// pivoting (a row takes the pivot only where its |a_ik| is STRICTLY above
// every magnitude of rows k..i-1, NaN-propagating; the displaced candidate
// moves into the taking row) and safe_denom clamps (|pivot|, |diagonal| >=
// 1e-12, sign kept), then back substitution to q̈ (B, n). Plain version:
// ops/cuda_resolve.pullback_resolve_structured_plain.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32): by the
// roofline, bytes (the randomized dual layout at n = 18 moves 28.9 KB an
// env, 0.0354 ms at B = 4096, against ~125 kFLOP an env, 7.6 us). In
// practice latency chains (each warp walks its env's chunks and the LU's
// columns one after the other) and, at n = 18, the instructions a staged
// row costs: L2 prefetches of the blocks ahead made every layout 13-30%
// slower (`kernel_probe.py k1ab`). The design it replaces (synchronous
// staging of 32 rows, TA x 2TA register tiles, rows moved and broadcast by
// shuffles, row-oriented back substitution, 16 warps an SM above n = 18,
// so two waves at B = 4096; it spilled at n = 12 and 18) took, device
// time at B = 4096 with the stream kept busy (H100 80GB HBM3, 700 W;
// PERF.md): n = 12 random 0.0262 ms, n = 18 randomized dual 0.1204 and
// handover 0.0714, n = 24 planar tick 0.0631, n = 32 random 0.1130 and
// planar tick 0.1220. `kernel_probe.py k1` split it: at n = 32 the seed
// (lane r reading row r of each identity block, 32 lines a load) took 31%,
// the elimination 34%, the back substitution 12%; at n = 18 the rows' sums
// 76%. This design halves the long arms' time (the seed along rows, one
// wave, no row moves, back substitution by columns); on the randomized
// dual layout the rows' sums stay near 0.09 ms in every design tried,
// where each env reads its 241 rows as 60-80 byte pieces of n planes
// (the motor-major J of the obstacle and inter-arm policies), PERF.md.
//
// Design.
// - One warp an env, 4 a CTA, at most 64 registers and 1,760 floats of
//   shared memory a warp, so that 8 CTAs (32 warps) sit on an SM at every
//   n and B = 4096 is one wave (the design before held 16 warps an SM
//   above n = 18: two waves).
// - Every block, identity blocks included, streams through a ring of 2
//   stages of the warp's shared memory, up to 32 rows a chunk, staged by
//   cp.async (float32; a bfloat16 element is widened through a register):
//   the next chunk is in flight while one is summed, and the CTA's 4 warps
//   take each chunk together (a __syncthreads a chunk), since their envs'
//   rows lie side by side in memory. Lanes run along whichever
//   of a tensor's row and column axes is contiguous, so the loads
//   coalesce; a row's pitch is odd, so a chunk's rows fall in distinct
//   banks. A staged row holds J (row factors) with v at column n, and a
//   dense block's W with v at column n (column factors; a scalar block's
//   are m J, formed in registers), so f is [A | f]'s column n.
// - Each lane keeps an a x b tile of [A | f] in registers over every
//   block; the tile shape at each n is the one with the fewest shared
//   loads a staged row (a + b + 1 over the G groups of lanes that take
//   every G-th row; best_tile), and the groups' tiles are summed at the
//   end. Identity rows are added into the tiles they cover. Then the tiles
//   go to shared memory as n rows of [A | f].
// - Elimination: lane r keeps physical row r of [A + ridge I | f] in
//   registers for the whole solve; rows never move. A permutation kept as
//   indices (`who`: the physical row at each logical position) stands for
//   the reference's row swaps: at column k the rows that take the pivot
//   are found by ballots over the magnitudes in logical order (each
//   record, the strict prefix maximum, with NaN ending the chain), and one
//   shuffle of `who` moves the chain k -> i1 -> ... -> im. The pivot row
//   goes to every lane by shuffles, and every row not yet a pivot
//   subtracts factor x pivot row as a product and then a difference,
//   rounded apart as the plain version's and the reference's elementwise
//   operations are, so an exactly assembled system takes the same pivots
//   and clamps bit for bit.
// - Back substitution by columns: x_i, on the lane that holds logical row
//   i, is broadcast once and every unsolved row subtracts a_ri x_i: a chain
//   of n steps, not n^2 / 2 dependent FMAs. Lane p stores x at p's logical
//   position.
#pragma once

#include <cuda_runtime.h>

#include "pullback_resolve.cuh"

namespace rmp_k1 {
namespace {

constexpr int kEnvs = 4;             // warps, one env each, per CTA
constexpr int kSmemFloats = 1760;    // a warp's share of 8 CTAs an SM
constexpr int kStages = 2;           // chunks in the ring: 1 in flight
constexpr int kStageFloats = kSmemFloats / kStages;
constexpr unsigned kAll = 0xffffffffu;

// The register tiles of [A | f] at n: a x b entries a lane, TR x TC tiles
// (TR = ceil(n / a), TC = ceil((n + 1) / b)), G groups of TR TC lanes that
// take every G-th staged row. A staged row's a + b factors are a + b
// shared loads a lane (one wavefront each when the G rows' words fall in
// distinct banks), so the tile is the one with the fewest loads a row,
// (a + b + 1) / G (the 1: a scalar row's m), with at most max_acc(n)
// entries (registers) a lane and at most 4 groups.
struct Tile {
  int a, b, tr, tc, g;
};
__host__ __device__ constexpr int max_acc(int n) {
  return n <= 20 ? 24 : n <= 28 ? 28 : n <= 31 ? 32 : 36;
}
// groups: at most 4 (their tiles are summed one after the other at the end)
__host__ __device__ constexpr int groups_of(int tiles) {
  return tiles > 32 ? 0 : 32 / tiles > 4 ? 4 : 32 / tiles;
}
__host__ __device__ constexpr Tile tile_at(int n, int a, int b) {
  return Tile{a, b, (n + a - 1) / a, (n + b) / b,
              groups_of(((n + a - 1) / a) * ((n + b) / b))};
}
__host__ __device__ constexpr bool tile_fits(int n, Tile t) {
  return t.a * t.b <= max_acc(n) && t.tr * t.tc <= 32;
}
// cost of a tile in 1/1000 loads a row (fewer entries break ties)
__host__ __device__ constexpr int tile_cost(Tile t) {
  return 1000 * (t.a + t.b + 1) / t.g * 64 + t.a * t.b;
}
__host__ __device__ constexpr Tile best_tile(int n, int a = 1, int b = 1,
                                             Tile best = Tile{0, 0, 0, 0, 0}) {
  return a > 12 ? best
         : b > 12
             ? best_tile(n, a + 1, 1, best)
             : best_tile(n, a, b + 1,
                         (tile_fits(n, tile_at(n, a, b)) &&
                          (best.a == 0 ||
                           tile_cost(tile_at(n, a, b)) < tile_cost(best)))
                             ? tile_at(n, a, b)
                             : best);
}
// floats a staged row: every column a tile reads, odd so that 32 rows
// fall in 32 distinct banks
__host__ __device__ constexpr int pitch(int n) {
  return ((best_tile(n).a * best_tile(n).tr > best_tile(n).b * best_tile(n).tc
               ? best_tile(n).a * best_tile(n).tr
               : best_tile(n).b * best_tile(n).tc) |
          1);
}
// rows a chunk of each kind holds in a stage: identity (M with v at column
// n), scalar (J with v at column n, and m), dense (J, and W with v at
// column n)
__host__ __device__ constexpr int cap_rows(int r) { return r > 32 ? 32 : r; }
__host__ __device__ constexpr int chunk_rows(int n, int kind) {
  return kind == kIdentity ? cap_rows(kStageFloats / pitch(n))
         : kind == kScalar ? cap_rows(kStageFloats / (pitch(n) + 1))
                           : cap_rows(kStageFloats / (2 * pitch(n)));
}

// Rows r0..r0+nr-1, columns 0..N-1 of block tensor p (element type T)
// into dst (pitch P): lane i takes row i where rows are contiguous in
// memory, else the lanes run along the columns.
template <int N, int P, class T>
__device__ __forceinline__ void stage_matrix(float* dst, const void* p,
                                             const long long* s, long long b,
                                             int r0, int nr, int lane) {
  const T* base = static_cast<const T*>(p) + b * s[0] + r0 * s[1];
  const long long srow = s[1] < 0 ? -s[1] : s[1];
  const long long scol = s[2] < 0 ? -s[2] : s[2];
  if (srow <= scol) {
    if (lane < nr) {
      const T* row = base + lane * s[1];
#pragma unroll
      for (int c = 0; c < N; ++c) copy(dst + lane * P + c, row + c * s[2]);
    }
  } else {
    for (int e = lane; e < nr * N; e += 32) {
      const int i = e / N;
      const int c = e - i * N;
      copy(dst + i * P + c, base + i * s[1] + c * s[2]);
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

// A chunk of block `blk` (rows r0.., nr of them) into the stage at `st`.
template <int N, int P, class T>
__device__ __forceinline__ void stage_chunk(float* st, const Block& blk,
                                            long long b, int r0, int nr,
                                            int lane) {
  constexpr int kC = chunk_rows(N, kScalar);
  if (blk.kind == kIdentity) {
    stage_matrix<N, P, T>(st, blk.ptr[0], blk.stride[0], b, r0, nr, lane);
    stage_vector<T>(st + N, P, blk.ptr[1], blk.stride[1], b, r0, nr, lane);
  } else if (blk.kind == kScalar) {
    stage_matrix<N, P, T>(st, blk.ptr[0], blk.stride[0], b, r0, nr, lane);
    stage_vector<T>(st + N, P, blk.ptr[2], blk.stride[2], b, r0, nr, lane);
    stage_vector<T>(st + kC * P, 1, blk.ptr[1], blk.stride[1], b, r0, nr,
                    lane);
  } else {
    constexpr int kD = chunk_rows(N, kDense);
    stage_matrix<N, P, T>(st, blk.ptr[0], blk.stride[0], b, r0, nr, lane);
    stage_matrix<N, P, T>(st + kD * P, blk.ptr[1], blk.stride[1], b, r0, nr,
                          lane);
    stage_vector<T>(st + kD * P + N, P, blk.ptr[2], blk.stride[2], b, r0, nr,
                    lane);
  }
}

template <int N, int P>
__device__ __forceinline__ void stage_any(float* st, const Block& blk,
                                          long long b, int r0, int nr,
                                          int lane) {
  if (blk.elem == kBFloat16)
    stage_chunk<N, P, bf16_t>(st, blk, b, r0, nr, lane);
  else
    stage_chunk<N, P, float>(st, blk, b, r0, nr, lane);
}

// Rows of a block and chunks of it, in tag order.
__device__ __forceinline__ int block_rows(const Block& blk, int n) {
  return blk.kind == kIdentity ? n : blk.rows;
}
template <int N>
__device__ __forceinline__ int chunk_of(const Block& blk) {
  return blk.kind == kIdentity ? chunk_rows(N, kIdentity)
         : blk.kind == kScalar ? chunk_rows(N, kScalar)
                               : chunk_rows(N, kDense);
}
template <int N>
__device__ __forceinline__ void next_chunk(const Table& table, int& k,
                                           int& r0) {
  r0 += chunk_of<N>(table.block[k]);
  if (r0 >= block_rows(table.block[k], N)) {
    ++k;
    r0 = 0;
  }
}

template <int N>
__global__ void __launch_bounds__(32 * kEnvs, 8)
    pullback_resolve_wide_kernel(int B, const __grid_constant__ Table table,
                                 float ridge, float* __restrict__ out) {
  constexpr Tile kT = best_tile(N);
  constexpr int A = kT.a, Bt = kT.b, G = kT.g;
  constexpr int P = pitch(N);
  constexpr int kTiles = kT.tr * kT.tc;
  static_assert(kT.a > 0 && kTiles <= 32 && G >= 1, "a tile at n");
  static_assert(N * P <= kSmemFloats, "[A | f] in the ring");
  static_assert(chunk_rows(N, kDense) >= 1, "a dense row in a stage");
  __shared__ float smem[kEnvs][kSmemFloats];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int env = blockIdx.x * kEnvs + w;
  // the ragged tail computes on a valid env and stores nothing
  const long long b = env < B ? env : B - 1;
  float* ring = smem[w];

  // this lane's tile: rows ra.., columns cb..; group g takes the staged
  // rows g, g + G, ...
  const int group = lane / kTiles;
  const int t = lane - group * kTiles;
  const bool active = group < G;
  const int ra = A * (t / kT.tc), cb = Bt * (t % kT.tc);
  float acc[A][Bt];
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < Bt; ++j) acc[i][j] = 0.0f;

  // ---- every block's rows, chunk by chunk through the ring ----
  int ik = 0, ir0 = 0;  // the next chunk to stage
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (ik < table.count) {
      const Block& blk = table.block[ik];
      stage_any<N, P>(ring + s * kStageFloats, blk, b, ir0,
                      min(chunk_of<N>(blk), block_rows(blk, N) - ir0), lane);
      next_chunk<N>(table, ik, ir0);
    }
    cp_async_commit();
  }
  int k = 0, r0 = 0, slot = 0;
  while (k < table.count) {
    if (ik < table.count) {
      const Block& blk = table.block[ik];
      stage_any<N, P>(ring + ((slot + kStages - 1) % kStages) * kStageFloats,
                      blk, b, ir0,
                      min(chunk_of<N>(blk), block_rows(blk, N) - ir0), lane);
      next_chunk<N>(table, ik, ir0);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    // the CTA's envs share their blocks' layout, so its warps take the
    // same chunk together: their rows lie side by side in memory
    __syncthreads();
    const float* st = ring + slot * kStageFloats;
    const Block& blk = table.block[k];
    const int nr = min(chunk_of<N>(blk), block_rows(blk, N) - r0);
    if (blk.kind == kIdentity) {
      // M's rows r0.. and v at column N, into the tiles they cover
      if (active && group == 0) {
#pragma unroll
        for (int i = 0; i < A; ++i) {
          const int r = ra + i - r0;
          if (r < 0 || r >= nr) continue;
#pragma unroll
          for (int j = 0; j < Bt; ++j) acc[i][j] += st[r * P + cb + j];
        }
      }
    } else if (blk.kind == kScalar) {
      // row factors J[i][ra..], column factors m J[i][cb..] (v at N)
      constexpr int kC = chunk_rows(N, kScalar);
      if (active) {
        for (int i = group; i < nr; i += G) {
          const float m = st[kC * P + i];
          float u[A];
#pragma unroll
          for (int q = 0; q < A; ++q) u[q] = st[i * P + ra + q];
#pragma unroll
          for (int j = 0; j < Bt; ++j) {
            const float x = st[i * P + cb + j];
            const float v = cb + j == N ? x : m * x;
#pragma unroll
            for (int q = 0; q < A; ++q) acc[q][j] += u[q] * v;
          }
        }
      }
    } else {
      // row factors J[i][ra..], column factors W[i][cb..] (v at N)
      constexpr int kD = chunk_rows(N, kDense);
      if (active) {
        for (int i = group; i < nr; i += G) {
          float u[A];
#pragma unroll
          for (int q = 0; q < A; ++q) u[q] = st[i * P + ra + q];
#pragma unroll
          for (int j = 0; j < Bt; ++j) {
            const float v = st[(kD + i) * P + cb + j];
#pragma unroll
            for (int q = 0; q < A; ++q) acc[q][j] += u[q] * v;
          }
        }
      }
    }
    __syncwarp();
    next_chunk<N>(table, k, r0);
    slot = (slot + 1) % kStages;
  }
  cp_async_wait<0>();
  __syncwarp();

  // ---- the tiles into [A | f] (the ring's floats), group after group ----
  float* sA = ring;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (active && group == g) {
#pragma unroll
      for (int i = 0; i < A; ++i) {
        if (ra + i >= N) continue;
#pragma unroll
        for (int j = 0; j < Bt; ++j) {
          if (cb + j > N) continue;
          float* e = sA + (ra + i) * P + cb + j;
          *e = g == 0 ? acc[i][j] : *e + acc[i][j];
        }
      }
    }
    __syncwarp();
  }

  // ---- rows of [A + ridge I | f]: lane r holds physical row r ----
  float row[N + 1];
  const bool real = lane < N;
  {
    const int r = real ? lane : 0;
#pragma unroll
    for (int c = 0; c <= N; ++c) row[c] = sA[r * P + c];
#pragma unroll
    for (int c = 0; c < N; ++c)
      if (c == lane) row[c] += ridge;
  }

  // ---- elimination ----
  // who: the physical row at logical position `lane` (lanes >= N: their
  // own, never read); done: this lane's row has been a pivot (lanes >= N
  // from the start); mypos, mydiag: where this row became the pivot, and
  // its pivot entry
  int who = lane;
  bool done = !real;
  int mypos = 0;
  float mydiag = 1.0f;
#pragma unroll
  for (int kk = 0; kk < N; ++kk) {
    // column kk in logical order; the records after kk: each magnitude
    // strictly above every one before it, none after the first NaN
    const float vall = __shfl_sync(kAll, row[kk], who);
    const float magl = fabsf(vall);
    const bool in = lane > kk && lane < N;
    float cur = __shfl_sync(kAll, magl, kk);
    int last = kk;
    unsigned takes = 0u;
    if (cur == cur) {
      // the lanes past `last` above cur, and those holding a NaN: the
      // first of them takes unless it is a NaN, which ends the chain
      unsigned next = __ballot_sync(kAll, in && !(magl <= cur));
      while (next) {
        const int i = __ffs(next) - 1;
        const float m = __shfl_sync(kAll, magl, i);
        if (m != m) break;
        last = i;
        takes |= 1u << i;
        cur = m;
        next &= __ballot_sync(kAll, !(magl <= cur)) & ~((2u << i) - 1u);
      }
    }
    // the pivot: the last record's row and value; the chain kk -> i1 ->
    // ... -> im: logical kk takes im's row, each taker the row of the
    // taker before it (kk's for the first)
    const int piv = __shfl_sync(kAll, who, last);
    const float pv = __shfl_sync(kAll, vall, last);
    const unsigned below = takes & ((1u << lane) - 1u);
    const int src = ((takes >> lane) & 1u)
                        ? (below ? 31 - __clz(below) : kk)
                        : (lane == kk ? last : lane);
    who = __shfl_sync(kAll, who, src);
    const float inv = __frcp_rn(clamp_ref(pv));
    if (lane == piv) {
      done = true;
      mypos = kk;
      mydiag = row[kk];
    }
    // rows not yet a pivot subtract factor x the pivot row (columns
    // kk+1..N), a product and then a difference as the reference rounds
    const float factor = __fmul_rn(row[kk], inv);
#pragma unroll
    for (int c = kk + 1; c <= N; ++c) {
      const float pc = __shfl_sync(kAll, row[c], piv);
      if (!done) row[c] = __fsub_rn(row[c], __fmul_rn(factor, pc));
    }
  }

  // ---- back substitution, by columns ----
  const float myinv = __frcp_rn(clamp_ref(mydiag));
  float mine = 0.0f;
  bool solved = !real;
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    const int p = __shfl_sync(kAll, who, i);
    const float xi = __shfl_sync(kAll, row[N] * myinv, p);
    if (lane == p) {
      mine = xi;
      solved = true;
    }
    if (!solved) row[N] -= row[i] * xi;
  }
  if (real && env < B) out[b * N + mypos] = mine;
}

template <int N>
void launch(int B, const Table& table, float ridge, float* out,
            cudaStream_t stream) {
  pullback_resolve_wide_kernel<N>
      <<<(B + kEnvs - 1) / kEnvs, 32 * kEnvs, 0, stream>>>(B, table, ridge,
                                                           out);
}

// launch<N> for the run-time n = N, N + 1, ..., Hi: each source file that
// includes this header instantiates the kernel for its own range of n
template <int N, int Hi>
void launch_range(int n, int B, const Table& table, float ridge, float* out,
                  cudaStream_t stream) {
  if (n == N) {
    launch<N>(B, table, ridge, out, stream);
  } else if constexpr (N < Hi) {
    launch_range<N + 1, Hi>(n, B, table, ridge, out, stream);
  }
}

}  // namespace
}  // namespace rmp_k1
