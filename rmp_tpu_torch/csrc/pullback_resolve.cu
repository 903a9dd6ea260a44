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
// Reach: every n from 1 to kMaxN = 64, as the TPU kernel unrolls over any
// n. The kernel below is instantiated for n = 1..9 (the two-joint robot, the
// UR5, the Panda, the planar N-link arms); n = 10..32 (the dual-arm Panda at
// 18, the N-link arms) run on the warp-per-env kernel of
// pullback_resolve_wide.cu, and n = 33..64 (four Pandas, the 64-link arm)
// on the CTA-per-env kernel of pullback_resolve_cta.cu; picked at run time,
// n > 64 and more than kMaxBlocks blocks are refused. The descriptor table, the element loads and
// the clamp are pullback_resolve.cuh's.
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

#include "pullback_resolve.cuh"

namespace {

using namespace rmp_k1;

constexpr int kGroup = 8;       // lanes per environment
constexpr int kThreads = 128;   // 16 environments per CTA

// The wrapper's descriptor row: kind, rows, 3 pointers, 9 strides, the
// element type.
constexpr int kRowWords = 15;

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

template <int N>
void launch(int B, const Table& table, float ridge, float* out,
            cudaStream_t stream) {
  constexpr int envs_per_cta = kThreads / kGroup;
  const int blocks = (B + envs_per_cta - 1) / envs_per_cta;
  pullback_resolve_kernel<N><<<blocks, kThreads, 0, stream>>>(B, table,
                                                              ridge, out);
}

// launch<N> for the run-time n = N, N + 1, ..., kMaxLaneN; above, the warp
// kernel, and past kMaxWarpN the CTA kernel
template <int N>
void launch_n(int n, int B, const Table& table, float ridge, float* out,
              cudaStream_t stream) {
  if (n == N) {
    launch<N>(B, table, ridge, out, stream);
  } else if constexpr (N < kMaxLaneN) {
    launch_n<N + 1>(n, B, table, ridge, out, stream);
  } else {
    if (n <= kMaxWarpN)
      launch_wide(n, B, table, ridge, out, stream);
    else
      launch_cta(n, B, table, ridge, out, stream);
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
