// K1: fused RMP pullback + pivoted-LU resolve, a group of lanes per
// environment, reading each policy block where it lies.
//
// Replaces the TPU kernel
// rmp_tpu/ops/pallas_resolve.py::pullback_resolve_structured
// (_kernel_structured, _lu_solve_lanes). Per environment b it accumulates
//   A = sum_identity M + sum_dense J^T W + sum_scalar J^T diag(m) J  (n x n)
//   f = sum_identity v + sum_dense J^T v + sum_scalar J^T v
// adds the ridge, and solves A x = f by unrolled Gaussian elimination with
// partial pivoting and sign-preserving clamps (|pivot|, |diagonal| >=
// 1e-12). Plain version: ops/cuda_resolve.pullback_resolve_structured_plain.
//
// Tie and clamp rules of the TPU kernel, kept exactly: a row replaces the
// running pivot only if its magnitude is STRICTLY greater, and the displaced
// row takes the candidate's place; every pivot and every back-substitution
// diagonal goes through safe_denom.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. In the flagship layout (n = 9;
// three identity blocks of 90 floats, a dense block of 3 x 19, a scalar
// block of 70 x 11, 9 out) the call moves 1,106 floats per env, 18.1 MB at
// B = 4096, so 5.4 us; its ~12 kFLOP per env take ~0.7 us at the fp32 peak.
//
// Reach: every n from 1 to kMaxN = 32, as the TPU kernel unrolls over any
// n. The kernel below is instantiated for n = 1..9 (the two-joint robot, the
// UR5, the Panda, the planar N-link arms), a second kernel of its own for
// n = 10..32 (a warp per env: the dual-arm Panda at 18, the N-link arms);
// picked at run time, n > 32 and more than kMaxBlocks blocks are refused.
//
// Block element types: each block's tensors are float32 or bfloat16 (the
// TPU kernel's block_dtype). A bfloat16 element is widened to float32 as it
// is loaded (its 16 bits are the high half of the float32 with the same
// value); every sum and the LU stay float32.
//
// Design.
// - One launch, no operand copies. The wrapper hands the blocks over as a
//   table of descriptors, by value (kind, rows, and for each tensor its
//   pointer and its (batch, row, column) strides in elements), and the
//   kernel reads every operand through its strides.
// - kGroup = 8 lanes per env, 4 envs per warp, 16 per CTA (1,024 warps at
//   B = 4096). The lanes split each block's rows (row r on lane r % 8); each
//   lane keeps partial sums of A (all n x n: a dense block's J^T W need not
//   be symmetric; a scalar row adds its upper triangle and mirrors it) and
//   of f in registers, and a butterfly of shuffles (xor 4, 2, 1) leaves the
//   group's sums on every lane. Eight lanes, not a warp, per env: the
//   butterfly is 3 x 90 shuffles for 4 envs, and the 73 flagship rows still
//   give each lane 9-10.
// - The identity blocks (no rows) are summed in tag order, (M1 + M2) + M3,
//   entry e on lane e % 8 (a block's 12 loads per lane issued together,
//   before the rows), into shared memory, and added to the reduced rows:
//   A = seed + rows. The scalar rows are unrolled by two, so two rows'
//   loads are in flight per lane.
// - Every lane of a group then runs the same elimination in registers (n is
//   a template parameter, so A and f are indexed at compile time) and lane 0
//   stores q̈.
// - Access patterns at the flagship's real strides (B = 4096): the scalar
//   block's J is stored motor-major, (n, B, R) = strides (70, 1, 70 B), and
//   its m and v are (B, 70) contiguous, so for a column i the 8 lanes of an
//   env read 8 consecutive floats and the warp's 4 envs follow each other
//   in memory; the dense J is a view of the EE frame's translation rows,
//   strides (192, 4, 192 B), read as 3 rows x 9 strided floats on lanes
//   0-2; the dense W (B, 3, 9), its v and the identity blocks' M (B, 9, 9)
//   and v (B, 9) are contiguous, read along their rows. No layout needs
//   staging through shared memory: the lanes of a group touch the same 128
//   byte lines, which L1 keeps.
#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 8;       // lanes per environment
constexpr int kThreads = 128;   // 16 environments per CTA
constexpr int kMaxLaneN = 9;    // n of the lane-group kernel; above, a warp
constexpr int kMaxN = 32;       // n of the warp kernel: one row per lane
// descriptors per call; the by-value table (3,592 bytes) stays inside the
// 4 KB of kernel parameters every CUDA version takes
constexpr int kMaxBlocks = 32;
constexpr int kIdentity = 0, kScalar = 1, kDense = 2;
constexpr int kFloat32 = 0, kBFloat16 = 1;  // element types

// One policy block: identity (M (B, n, n), v (B, n)), scalar (J (B, R, n),
// m (B, R), v (B, R)) or dense (J (B, R, n), W (B, R, n), v (B, R)), all
// of element type `elem`.
struct Block {
  int kind;
  int rows;
  int elem;
  const void* ptr[3];
  long long stride[3][3];  // (batch, row, column) of each tensor, elements
};

struct Table {
  int count;
  Block block[kMaxBlocks];
};

// The wrapper's descriptor row: kind, rows, 3 pointers, 9 strides, the
// element type.
constexpr int kRowWords = 15;

__device__ __forceinline__ float safe_denom(float d) {
  const float eps = 1e-12f;
  return d >= 0.0f ? fmaxf(d, eps) : fminf(d, -eps);
}

// A bfloat16 element: the high 16 bits of the float32 of the same value.
struct bf16_t {
  unsigned short bits;
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const bf16_t* p) {
  const unsigned short h = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(h) << 16);
}

// Element (b, r, c) of a block tensor of element type T, as float32. The
// row loops are instantiated per element type, so their loads branch on
// nothing.
template <class T>
__device__ __forceinline__ float at(const void* p, const long long* s,
                                    long long b, long long r, long long c) {
  return load(static_cast<const T*>(p) + b * s[0] + r * s[1] + c * s[2]);
}
// The same for the block's element type read at run time (the lane
// kernel's identity seed).
__device__ __forceinline__ float at(const void* p, int elem,
                                    const long long* s, long long b,
                                    long long r, long long c) {
  return elem == kBFloat16 ? at<bf16_t>(p, s, b, r, c)
                           : at<float>(p, s, b, r, c);
}

// The rows of one scalar or dense block into a lane's partial sums: lane
// r % kGroup takes row r.
template <int N, class T>
__device__ __forceinline__ void add_rows(float (&A)[N][N], float (&f)[N],
                                         const Block& blk, long long b,
                                         int lane) {
  const void* J = blk.ptr[0];
  const void* X = blk.ptr[1];  // m (scalar) or W (dense)
  const void* V = blk.ptr[2];
  const long long* sJ = blk.stride[0];
  const long long* sX = blk.stride[1];
  const long long* sV = blk.stride[2];
  if (blk.kind == kScalar) {
#pragma unroll 2
    for (int r = lane; r < blk.rows; r += kGroup) {
      float Jr[N];
#pragma unroll
      for (int i = 0; i < N; ++i) Jr[i] = at<T>(J, sJ, b, r, i);
      const float m = at<T>(X, sX, b, r, 0);
      const float v = at<T>(V, sV, b, r, 0);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        f[i] += Jr[i] * v;
        const float Jm = Jr[i] * m;
#pragma unroll
        for (int j = i; j < N; ++j) {
          const float a = Jm * Jr[j];
          A[i][j] += a;
          if (j > i) A[j][i] += a;
        }
      }
    }
  } else if (blk.kind == kDense) {
    for (int r = lane; r < blk.rows; r += kGroup) {
      float Jr[N], Wr[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        Jr[i] = at<T>(J, sJ, b, r, i);
        Wr[i] = at<T>(X, sX, b, r, i);
      }
      const float v = at<T>(V, sV, b, r, 0);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        f[i] += Jr[i] * v;
#pragma unroll
        for (int j = 0; j < N; ++j) A[i][j] += Jr[i] * Wr[j];
      }
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads) pullback_resolve_kernel(
    int B, const __grid_constant__ Table table, float ridge,
    float* __restrict__ out) {
  constexpr int kSeed = N * N + N;
  __shared__ float seed[kThreads / kGroup][kSeed];
  const int lane = threadIdx.x % kGroup;
  const int group = threadIdx.x / kGroup;
  const int env = blockIdx.x * (kThreads / kGroup) + group;
  // the ragged tail computes on a valid env and stores nothing
  const long long b = env < B ? env : B - 1;

  float A[N][N];
  float f[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    f[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < N; ++j) A[i][j] = 0.0f;
  }

  // the identity seed, entry e (A row-major, then f) on lane e % kGroup,
  // summed over the identity blocks in tag order; a block's kPerLane loads
  // per lane are independent, so they are in flight together
  constexpr int kPerLane = (kSeed + kGroup - 1) / kGroup;
  float part[kPerLane];
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) part[t] = 0.0f;
  bool has_identity = false;
  for (int k = 0; k < table.count; ++k) {
    const Block& blk = table.block[k];
    if (blk.kind != kIdentity) continue;
    has_identity = true;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int e = lane + kGroup * t;
      if (e < N * N)
        part[t] += at(blk.ptr[0], blk.elem, blk.stride[0], b, e / N, e % N);
      else if (e < kSeed)
        part[t] += at(blk.ptr[1], blk.elem, blk.stride[1], b, e - N * N, 0);
    }
  }
  if (has_identity) {
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int e = lane + kGroup * t;
      if (e < kSeed) seed[group][e] = part[t];
    }
  }

  // rows: lane r % kGroup takes row r of each block, blocks in tag order
  for (int k = 0; k < table.count; ++k) {
    const Block& blk = table.block[k];
    if (blk.kind == kIdentity) continue;
    if (blk.elem == kBFloat16)
      add_rows<N, bf16_t>(A, f, blk, b, lane);
    else
      add_rows<N, float>(A, f, blk, b, lane);
  }

  // butterfly over the group's lanes: every lane ends with the same sums
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int off = kGroup / 2; off > 0; off /= 2)
      f[i] += __shfl_xor_sync(0xffffffffu, f[i], off);
#pragma unroll
    for (int j = 0; j < N; ++j) {
#pragma unroll
      for (int off = kGroup / 2; off > 0; off /= 2)
        A[i][j] += __shfl_xor_sync(0xffffffffu, A[i][j], off);
    }
  }
  if (has_identity) {
    __syncwarp();
#pragma unroll
    for (int i = 0; i < N; ++i) {
      f[i] = seed[group][N * N + i] + f[i];
#pragma unroll
      for (int j = 0; j < N; ++j) A[i][j] = seed[group][N * i + j] + A[i][j];
    }
  }

#pragma unroll
  for (int i = 0; i < N; ++i) A[i][i] += ridge;

  // elimination with partial pivoting; rows k..N-1, columns k..N-1 plus f
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float piv_mag = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      const float mag = fabsf(A[i][k]);
      const bool take = mag > piv_mag;
#pragma unroll
      for (int c = k; c < N; ++c) {
        const float p = A[k][c], q = A[i][c];
        A[k][c] = take ? q : p;
        A[i][c] = take ? p : q;
      }
      const float p = f[k], q = f[i];
      f[k] = take ? q : p;
      f[i] = take ? p : q;
      piv_mag = take ? mag : piv_mag;
    }
    const float inv_pivot = 1.0f / safe_denom(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      const float factor = A[i][k] * inv_pivot;
#pragma unroll
      for (int c = k; c < N; ++c) A[i][c] -= factor * A[k][c];
      f[i] -= factor * f[k];
    }
  }

  float x[N];
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float s = f[i];
#pragma unroll
    for (int j = i + 1; j < N; ++j) s -= A[i][j] * x[j];
    x[i] = s / safe_denom(A[i][i]);
  }
  if (lane == 0 && env < B) {
#pragma unroll
    for (int i = 0; i < N; ++i) out[b * N + i] = x[i];
  }
}

// ---- n = 10..32: one warp per environment ---------------------------------
//
// The n <= 9 design above keeps all of A and f on every lane of a group; at
// n = 18 that is 342 accumulators per lane, which spill. Here a warp takes
// an env.
// - Rows: each block's rows are staged kTileRows at a time into the warp's
//   shared tile, read where they lie through the block's strides, with the
//   lanes running along whichever of the row and column axes is contiguous
//   in memory (the motor-major scalar J of the obstacle policies: rows; a
//   (B, R, n) dense block: columns), so the warp's loads coalesce. Lane
//   t < GA GB owns a TA x TB tile of A (rows TA (t / GB).., columns
//   TB (t % GB)..) in registers and adds J[i][r] W[i][c] (dense) or
//   (J[i][r] m[i]) J[i][c] (scalar) for each staged row i, reading its
//   TA + TB factors from the tile; the column-0 lanes also add J[i][r] v[i]
//   to f. The tile shape is the one with the fewest products per lane:
//   TB = 2 TA (the column factors come as float2s), TA the least with
//   ceil(n / TA) ceil(n / TB) <= 32 tiles (3 x 6 on 18 lanes at n = 18,
//   4 x 8 on 32 at n = 32). Tile entries past n compute on the staged
//   tile's unused columns and are never stored. The tiles go through shared
//   memory into rows, lane r holding row r of [A | f]. Then the identity
//   blocks are summed in tag order into a seed, row r on lane r, read only
//   now so that its n + 1 sums hold no registers through the rows, and
//   A = seed + rows, as at n <= 9. Lanes past the tiles and past n idle.
//   The kernel is latency-bound, far from its byte bound: on the randomized
//   dual layout (n = 18; H100 80GB HBM3, 700 W) a first design, lane r
//   owning row r of A through the rows and reading a row's 18 factors as
//   broadcast float4s, took 0.160 ms at 80 registers; the tiles at 64
//   registers (8 CTAs an SM, no spill) 0.127 ms, at 80 (6 CTAs) 0.132.
// - Elimination: the reference's pivot rule is a sequential scan. At
//   column k the running pivot starts as row k; each row i > k whose
//   |a_ik| is STRICTLY greater than every magnitude before it (rows k..i-1)
//   takes the pivot's place, and the displaced candidate moves into row
//   i. So the rows that take form a chain k -> i1 -> ... -> im: row k goes
//   to i1, i1 to i2, ..., im becomes the pivot. A warp prefix maximum of
//   the magnitudes (NaN-propagating, as the reference's running maximum)
//   finds the rows that take, a ballot their chain, and one shuffle per
//   column moves every row at once. Then the pivot row is broadcast by
//   shuffles and lanes i > k eliminate, with safe_denom on the pivot. Lanes
//   at n and past it take no part in the scan and never move a row.
// - Back substitution in the reference's order: x_i = (f_i - sum over j
//   = i+1..n-1 of a_ij x_j) / safe_denom(a_ii), every lane on its own row,
//   lane i's value broadcast; lane r stores x_r.
constexpr int kWideEnvs = 4;    // warps, one env each, per CTA
constexpr int kTileRows = 32;   // rows staged per pass

// The warp kernel's tile rows TA (TB = 2 TA) at n.
__host__ __device__ constexpr int tile_rows(int n, int ta = 1) {
  return ((n + ta - 1) / ta) * ((n + 2 * ta - 1) / (2 * ta)) <= 32
             ? ta
             : tile_rows(n, ta + 1);
}
// Columns the tiles cover at n, and floats per staged row: those columns
// and [A | f]'s n + 1, rounded up to 16 bytes.
__host__ __device__ constexpr int tile_cols(int n) {
  return (n + 2 * tile_rows(n) - 1) / (2 * tile_rows(n)) * 2 * tile_rows(n);
}
__host__ __device__ constexpr int wide_pitch(int n) {
  return ((tile_cols(n) > n + 1 ? tile_cols(n) : n + 1) + 3) / 4 * 4;
}
// resident CTAs per SM asked of the compiler: at n <= 18, 64 registers a
// thread, 32 warps an SM (9 or 10 CTAs spill at n = 18); above, the rows'
// n + 1 and the solution's n floats per lane need up to 128
__host__ __device__ constexpr int wide_ctas(int n) { return n <= 18 ? 8 : 4; }

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

// Stage rows r0..r0+nr-1 (all N columns) of block tensor p, of element
// type T, into tile.
template <int N, class T, int P>
__device__ __forceinline__ void stage_rows(float (*tile)[P], const void* p,
                                           const long long* s, long long b,
                                           int r0, int nr, int lane) {
  const long long srow = s[1] < 0 ? -s[1] : s[1];
  const long long scol = s[2] < 0 ? -s[2] : s[2];
  if (srow <= scol) {  // rows contiguous: lane i takes row i
    if (lane < nr) {
#pragma unroll
      for (int c = 0; c < N; ++c)
        tile[lane][c] = at<T>(p, s, b, r0 + lane, c);
    }
  } else {  // columns contiguous: element e is (e / n, e % n)
    for (int e = lane; e < nr * N; e += 32) {
      const int i = e / N;
      const int c = e - i * N;
      tile[i][c] = at<T>(p, s, b, r0 + i, c);
    }
  }
}

// Stage rows r0..r0+nr-1 of a scalar or dense block of element type T: J
// (and a dense block's W) into the tiles, a scalar block's m and the
// block's v into sM, sV.
template <int N, class T, int P>
__device__ __forceinline__ void stage_block(float (*tJ)[P], float (*tX)[P],
                                            float* tM, float* tV,
                                            const Block& blk, bool scalar,
                                            long long b, int r0, int nr,
                                            int lane) {
  stage_rows<N, T>(tJ, blk.ptr[0], blk.stride[0], b, r0, nr, lane);
  if (!scalar) stage_rows<N, T>(tX, blk.ptr[1], blk.stride[1], b, r0, nr,
                                lane);
  if (lane < nr) {
    tM[lane] = scalar ? at<T>(blk.ptr[1], blk.stride[1], b, r0 + lane, 0)
                      : 0.0f;
    tV[lane] = at<T>(blk.ptr[2], blk.stride[2], b, r0 + lane, 0);
  }
}

// Row r of an identity block of element type T added into seed.
template <int N, class T>
__device__ __forceinline__ void add_seed(float (&seed)[N + 1],
                                         const Block& blk, long long b,
                                         int r) {
#pragma unroll
  for (int c = 0; c < N; ++c)
    seed[c] += at<T>(blk.ptr[0], blk.stride[0], b, r, c);
  seed[N] += at<T>(blk.ptr[1], blk.stride[1], b, r, 0);
}

template <int N>
__global__ void __launch_bounds__(32 * kWideEnvs, wide_ctas(N))
    pullback_resolve_wide_kernel(
    int B, const __grid_constant__ Table table, float ridge,
    float* __restrict__ out) {
  constexpr int kTileA = tile_rows(N), kTileB = 2 * kTileA;
  constexpr int kGroupsB = (N + kTileB - 1) / kTileB;
  constexpr int kTiles = ((N + kTileA - 1) / kTileA) * kGroupsB;
  constexpr int kPitch = wide_pitch(N);
  static_assert(kTiles <= 32 && kTileA * ((N + kTileA - 1) / kTileA) <= kPitch,
                "the tiles must fit a warp and the staged rows");
  __shared__ __align__(16) float sJ[kWideEnvs][kTileRows][kPitch];
  __shared__ __align__(16) float sX[kWideEnvs][kTileRows][kPitch];
  __shared__ float sM[kWideEnvs][kTileRows];
  __shared__ float sV[kWideEnvs][kTileRows];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int env = blockIdx.x * kWideEnvs + w;
  // the ragged tail computes on a valid env and stores nothing
  const long long b = env < B ? env : B - 1;
  const int r = lane < N ? lane : N - 1;  // lanes >= N shadow row N - 1

  // the rows of every other block, in tag order, into lane t's tile of
  // A: rows kTileA g + a, columns kTileB h + c (t = kGroupsB g + h <
  // kTiles; the lanes past the tiles shadow lane 0); the h = 0 lanes also
  // sum f of their rows
  const int t = lane < kTiles ? lane : 0;
  const int ra = kTileA * (t / kGroupsB), cb = kTileB * (t % kGroupsB);
  float acc[kTileA][kTileB], facc[kTileA];
#pragma unroll
  for (int a = 0; a < kTileA; ++a) {
    facc[a] = 0.0f;
#pragma unroll
    for (int c = 0; c < kTileB; ++c) acc[a][c] = 0.0f;
  }
  for (int k = 0; k < table.count; ++k) {
    const Block& blk = table.block[k];
    if (blk.kind == kIdentity) continue;
    const bool scalar = blk.kind == kScalar;
    for (int r0 = 0; r0 < blk.rows; r0 += kTileRows) {
      const int nr = min(kTileRows, blk.rows - r0);
      __syncwarp();
      if (blk.elem == kBFloat16)
        stage_block<N, bf16_t>(sJ[w], sX[w], sM[w], sV[w], blk, scalar, b,
                               r0, nr, lane);
      else
        stage_block<N, float>(sJ[w], sX[w], sM[w], sV[w], blk, scalar, b,
                              r0, nr, lane);
      __syncwarp();
      for (int i = 0; i < nr; ++i) {
        const float* Jrow = sJ[w][i];
        // the other factor: J itself (scalar, its rows scaled by m) or W
        const float* X = scalar ? Jrow : sX[w][i];
        const float m = sM[w][i];
        const float v = sV[w][i];
        float xc[kTileB];
#pragma unroll
        for (int c = 0; c < kTileB; c += 2) {
          const float2 x2 = *reinterpret_cast<const float2*>(X + cb + c);
          xc[c] = x2.x;
          xc[c + 1] = x2.y;
        }
#pragma unroll
        for (int a = 0; a < kTileA; ++a) {
          const float jr = Jrow[ra + a];
          facc[a] += jr * v;
          const float w_r = scalar ? jr * m : jr;
#pragma unroll
          for (int c = 0; c < kTileB; ++c) acc[a][c] += w_r * xc[c];
        }
      }
    }
  }
  // the tiles into rows: lane r takes row r of [A | f] through the warp's
  // staging tile
  __syncwarp();
  float (*sA)[kPitch] = sJ[w];
  if (lane < kTiles) {
#pragma unroll
    for (int a = 0; a < kTileA; ++a) {
      if (ra + a >= N) continue;
#pragma unroll
      for (int c = 0; c < kTileB; ++c)
        if (cb + c < N) sA[ra + a][cb + c] = acc[a][c];
      if (cb == 0) sA[ra + a][N] = facc[a];
    }
  }
  __syncwarp();

  // the identity seed, row r, summed over the identity blocks in tag order
  float seed[N + 1];
#pragma unroll
  for (int c = 0; c <= N; ++c) seed[c] = 0.0f;
  bool has_identity = false;
  for (int k = 0; k < table.count; ++k) {
    const Block& blk = table.block[k];
    if (blk.kind != kIdentity) continue;
    has_identity = true;
    if (blk.elem == kBFloat16)
      add_seed<N, bf16_t>(seed, blk, b, r);
    else
      add_seed<N, float>(seed, blk, b, r);
  }

  // row r of [A + ridge I | f]
  float row[N + 1];
#pragma unroll
  for (int c = 0; c < N; ++c) {
    row[c] = has_identity ? seed[c] + sA[r][c] : sA[r][c];
    row[c] += (c == r) ? ridge : 0.0f;
  }
  row[N] = has_identity ? seed[N] + sA[r][N] : sA[r][N];

  constexpr unsigned kAll = 0xffffffffu;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    // the rows that take the pivot: |a_ik| above every magnitude of rows
    // k..i-1 (an inclusive prefix maximum over lanes k..N-1, shifted)
    const float mag = fabsf(row[k]);
    float run = (lane >= k && lane < N) ? mag : -1.0f;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const float up = __shfl_up_sync(kAll, run, off);
      if (lane >= off) run = nan_max(run, up);
    }
    const float before = __shfl_up_sync(kAll, run, 1);
    const bool take = lane > k && lane < N && mag > before;
    const unsigned takes = __ballot_sync(kAll, take);
    const unsigned below = takes & ((1u << lane) - 1u);
    const int src = take ? (below ? 31 - __clz(below) : k)
                         : (lane == k ? (takes ? 31 - __clz(takes) : k)
                                      : lane);
#pragma unroll
    for (int c = k; c <= N; ++c) row[c] = __shfl_sync(kAll, row[c], src);

    const float inv_pivot =
        1.0f / safe_denom(__shfl_sync(kAll, row[k], k));
    const float factor = row[k] * inv_pivot;
#pragma unroll
    for (int c = k; c <= N; ++c) {
      const float p = __shfl_sync(kAll, row[c], k);
      if (lane > k) row[c] -= factor * p;
    }
  }

  float x[N];
  float mine = 0.0f;
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float s = row[N];
#pragma unroll
    for (int j = i + 1; j < N; ++j) s -= row[j] * x[j];
    const float xi = s / safe_denom(row[i]);
    x[i] = __shfl_sync(kAll, xi, i);
    if (lane == i) mine = xi;
  }
  if (lane < N && env < B) out[b * N + lane] = mine;
}

template <int N>
void launch(int B, const Table& table, float ridge, float* out,
            cudaStream_t stream) {
  if constexpr (N <= kMaxLaneN) {
    constexpr int envs_per_cta = kThreads / kGroup;
    const int blocks = (B + envs_per_cta - 1) / envs_per_cta;
    pullback_resolve_kernel<N><<<blocks, kThreads, 0, stream>>>(B, table,
                                                                ridge, out);
  } else {
    pullback_resolve_wide_kernel<N>
        <<<(B + kWideEnvs - 1) / kWideEnvs, 32 * kWideEnvs, 0, stream>>>(
            B, table, ridge, out);
  }
}

// launch<N> for the run-time n = N, N + 1, ..., kMaxN
template <int N>
void launch_n(int n, int B, const Table& table, float ridge, float* out,
              cudaStream_t stream) {
  if (n == N) {
    launch<N>(B, table, ridge, out, stream);
  } else if constexpr (N < kMaxN) {
    launch_n<N + 1>(n, B, table, ridge, out, stream);
  }
}

}  // namespace

// `rows` is the wrapper's descriptor table, `count` rows of kRowWords
// 64-bit words: kind, rows, the three tensors' addresses (0 for an absent
// one), their (batch, row, column) strides in elements, then the element
// type (kFloat32, kBFloat16). Output: (B, n) float32, contiguous. Launches
// on `stream` of GPU `device` (the caller's current device is restored).
// Returns cudaGetLastError() after the launch, -1 when n is outside
// 1..kMaxN, -2 when there are more than kMaxBlocks blocks, -3 for an
// unknown element type (nothing is launched then).
extern "C" int rmp_pullback_resolve(int device, int n, int B,
                                    const long long* rows, int count,
                                    float ridge, float* out, void* stream) {
  if (n < 1 || n > kMaxN) return -1;
  if (count > kMaxBlocks) return -2;
  Table table{};
  table.count = count;
  for (int k = 0; k < count; ++k) {
    const long long* w = rows + k * kRowWords;
    Block& blk = table.block[k];
    blk.kind = static_cast<int>(w[0]);
    blk.rows = static_cast<int>(w[1]);
    for (int t = 0; t < 3; ++t) {
      blk.ptr[t] = reinterpret_cast<const void*>(w[2 + t]);
      for (int d = 0; d < 3; ++d) blk.stride[t][d] = w[5 + 3 * t + d];
    }
    blk.elem = static_cast<int>(w[14]);
    if (blk.elem != kFloat32 && blk.elem != kBFloat16) return -3;
  }
  if (B <= 0) return 0;
  int previous = device;
  cudaGetDevice(&previous);
  if (previous != device) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  launch_n<1>(n, B, table, ridge, out, static_cast<cudaStream_t>(stream));
  const int rc = static_cast<int>(cudaGetLastError());
  if (previous != device) cudaSetDevice(previous);
  return rc;
}
