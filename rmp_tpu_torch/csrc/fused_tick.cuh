// K5: the whole v2 tick in one kernel, a tile of environments per CTA and
// 16 lanes per environment.
//
// Replaces the TPU kernel rmp_tpu/ops/pallas_tick.py::make_fused_qdd
// (_make_kernel, _seg_closest). Per env it computes
//   1. the FK twist recursion (T, W, Wd, G per frame; fk_common.cuh, shared
//      with K3),
//   2. position, velocity, Jacobian and curvature of the EE origin and of
//      every collision frame origin: J[:, m] = (G_anc T)_xyz t,
//      c = ((Wd + W W) t)_xyz,
//   3. the first capsule of each collision frame against each obstacle
//      capsule: clamped segment closest points,
//   4. the distance rows in closed form (frozen offset: dd/dq = n^T J_origin,
//      c_d = n^T c_origin + (|pd|^2 - (n^T pd)^2) / d),
//   5. the attractor, the identity-space leaves (velocity cap, damping,
//      c-space bias) and the obstacle policy, pulled back into
//      A = sum J^T M J (ridge on the diagonal from the start) and
//      f = sum J^T M (a - c),
//   6. the unrolled Cholesky of 0.5 (A + A^T), pivot squares clamped to
//      1e-12, and its two triangular solves,
// and writes only qdd (B, n). Plain version: ops/cuda_tick.fused_qdd_plain.
// Reach: n = 1..kMaxN motors (one instantiation each, picked at run time),
// up to kMaxFrames frames; past them the wrapper takes the warp-per-env
// kernel of fused_tick_wide.cu (n <= 32, 40 frames), as the TPU kernel
// takes any model.n_q. The policy arithmetic both share is in
// fused_policy.cuh.
//
// The arithmetic of each term follows the JAX body: structural zeros are
// skipped, not multiplied (a Jacobian column of a motor that is no ancestor
// of the frame, read from `anc`), so a 0 * inf of the velocity cap's
// singularity never becomes a NaN where the reference gives a number;
// max/min/clip propagate NaN as jnp's do; the policy constants arrive
// folded in float64 and rounded once (consts). The sums of A and f take
// another order than the JAX body's (below), and nvcc contracts a * b + c
// into FMAs: results part from the plain version by rounding (chip_smoke.py
// holds them to 2e-4 x max(1, |qdd|)), and the logistic is 1 / (1 + expf(-x)).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32): operations. Per env it
// reads 21 + 7K floats and writes n = 9 (316 B at K = 7) but does 23,269
// operations at the flagship (10 collision frames x 7 obstacles): the
// reference body's, constants folded, less A's mirrored upper triangle
// (ops/tick_ops.fused_qdd_ops). This kernel folds no constant of the model.
//
// Design, after K3's.
// - A CTA takes kEnvs = 8 consecutive envs, 16 lanes each (512 CTAs at
//   B = 4096); the last tile computes on its last env and stores nothing
//   for the rest.
// - The model's tables and the tile's q, qd go to shared memory; a prologue
//   computes each (env, frame)'s joint motion and each frame's generator
//   once; the env's 16 lanes run the recursion (rmp::fk_recursion) on
//   shared memory, one lane per 4x4 entry.
// - The lanes then write, per point frame (the EE, then each collision
//   frame) and row i, the origin's position, velocity, curvature, Jacobian
//   row and, for a collision frame, its capsule's two ends in world
//   coordinates: a frame slot of 15 + 3n floats, over the memory the
//   recursion's joint motions held.
// - Work items: the n_col x K (frame, obstacle) pairs in order, then the
//   attractor, then the identity-space leaves in policy order; item t runs
//   on lane t % 16. Each lane accumulates the lower triangle of A (its ridge
//   on lane 0) and f in registers; a butterfly of xor shuffles (8, 4, 2, 1)
//   leaves the totals on all 16 lanes, bit for bit alike.
// - Every lane runs the Cholesky (A is exactly symmetric, so 0.5 (A + A^T)
//   is 0.5 (a + a) per entry, kept for its rounding at overflow); lane 0
//   stores qdd.
//
// The kernel's n = 1..16 instantiations are split over three source files,
// which nvcc builds at once, one process each: fused_tick.cu (n = 1..9, and
// the C entry points), fused_tick_10.cu (10..13) and fused_tick_14.cu
// (14..16).
#pragma once

#include <cuda_runtime.h>

#include "fk_common.cuh"
#include "fused_policy.cuh"

namespace rmp_k5 {

// The 16-lane kernel's launch: its arguments and the stream.
struct NarrowLaunch {
  int B, F, K, n_col, ee_frame, n_ident;
  const int *parent, *joint_type, *q_index;
  const float *axis, *T_constant;
  const int *anc, *col_frames;
  const float* caps;
  const int* ident;
  const float *consts, *q, *qd, *goal, *obs_p0, *obs_p1, *obs_r;
  float* out;
  cudaStream_t stream;
};

// n = 10..13 (fused_tick_10.cu) and 14..16 (fused_tick_14.cu): launch on
// a.stream, return nothing; the caller reads cudaGetLastError().
void launch_narrow_10(int n, const NarrowLaunch& a);
void launch_narrow_14(int n, const NarrowLaunch& a);

}  // namespace rmp_k5

namespace {

using namespace rmp;

constexpr int kMaxFrames = 16;
constexpr int kMaxN = 16;
constexpr int kEnvs = 8;              // envs per CTA
constexpr int kLanes = 16;            // lanes per env
constexpr int kThreads = kLanes * kEnvs;
constexpr int kMaxCollision = 16;
constexpr int kMaxIdentity = 8;

// A point frame's slot: origin p, velocity pd, curvature c, the Jacobian
// rows (3 x n, row-major; 0 on the motors that do not drive the frame) and
// the first capsule's two ends a0, a1 in world coordinates.
constexpr int kSlotP = 0, kSlotPd = 3, kSlotC = 6, kSlotJ = 9;
__host__ __device__ constexpr int slot_a0(int n) { return 9 + 3 * n; }
__host__ __device__ constexpr int slot_floats(int n) { return 15 + 3 * n; }

// Float offsets of the shared-memory arrays, then the int tables. Per env:
// T, W, C (Wd, then Wd + W W) at env stride `tstride` (F x 16 floats), the
// generators at pitch kGPitch and stride `gstride`, and a union region at
// stride `ustride`: the joint motions' transposes Tv (F x 16) and the
// recursion's scratch (48) first, the n_col + 1 frame slots after. Per
// model: the constant transforms Tc, the joint generators' transposes Et,
// the identity and zero matrices, the axes and the collision capsules
// (n_col x 7); per env q and qd.
struct Layout {
  int tstride, gstride, ustride;
  int T, W, C, G, U, Tc, Et, eye, axis, caps, q, qd, floats;
  int parent, type, qidx, anc, colf, ints;
  __host__ __device__ constexpr Layout(int F, int n, int n_col)
      : tstride(odd_half(16 * F)), gstride(odd_half(kGPitch * F)),
        ustride(odd_half(16 * F + 48 > slot_floats(n) * (n_col + 1)
                             ? 16 * F + 48
                             : slot_floats(n) * (n_col + 1))),
        T(0), W(kEnvs * tstride), C(2 * kEnvs * tstride),
        G(3 * kEnvs * tstride), U(G + kEnvs * gstride), Tc(U + kEnvs * ustride),
        Et(Tc + 16 * F), eye(Et + 16 * F), axis(eye + 32), caps(axis + 3 * F),
        q(caps + 7 * n_col), qd(q + kEnvs * n), floats(qd + kEnvs * n),
        parent(0), type(F), qidx(2 * F), anc(3 * F), colf(anc + F * n),
        ints(colf + n_col) {}
  __host__ __device__ constexpr int bytes() const {
    return 4 * (floats + ints);
  }
};

// Row i of a point frame's slot: frame f's origin (ph = its homogeneous
// coordinates) and, where cap is not null, the capsule's ends.
template <int N>
__device__ __forceinline__ void frame_row(float* slot, int i, int f,
                                          const float* T, const float* W,
                                          const float* Cc, const float* G,
                                          const int* anc, const float* cap) {
  const float* Tf = T + 16 * f;
  const float ph0 = Tf[3], ph1 = Tf[7], ph2 = Tf[11];
  const float* Wf = W + 16 * f + 4 * i;
  const float* Cf = Cc + 16 * f + 4 * i;
  slot[kSlotP + i] = Tf[4 * i + 3];
  slot[kSlotPd + i] = Wf[0] * ph0 + Wf[1] * ph1 + Wf[2] * ph2 + Wf[3];
  slot[kSlotC + i] = Cf[0] * ph0 + Cf[1] * ph1 + Cf[2] * ph2 + Cf[3];
#pragma unroll
  for (int m = 0; m < N; ++m) {
    const int j = anc[f * N + m];
    const float* Gj = G + kGPitch * (j < 0 ? 0 : j) + 4 * i;
    slot[kSlotJ + N * i + m] =
        j >= 0 ? Gj[0] * ph0 + Gj[1] * ph1 + Gj[2] * ph2 + Gj[3] : 0.0f;
  }
  if (cap != nullptr) {
    const float* Ti = Tf + 4 * i;
    slot[slot_a0(N) + i] = Ti[0] * cap[0] + Ti[1] * cap[1] + Ti[2] * cap[2] + Ti[3];
    slot[slot_a0(N) + 3 + i] =
        Ti[0] * cap[3] + Ti[1] * cap[4] + Ti[2] * cap[5] + Ti[3];
  }
}

// The attractor on the EE position: slot is the EE's, act its motors.
template <int N>
__device__ __forceinline__ void attractor(float (&A)[N][N], float (&fs)[N],
                                          const float* __restrict__ C,
                                          const float* slot, const int* anc,
                                          const float* goal) {
  float J[3][N];
  bool act[N];
#pragma unroll
  for (int m = 0; m < N; ++m) {
    act[m] = anc[m] >= 0;
#pragma unroll
    for (int i = 0; i < 3; ++i) J[i][m] = slot[kSlotJ + N * i + m];
  }
  float M[3][3], u[3];
  attractor_terms(M, u, C, slot + kSlotP, slot + kSlotPd, slot + kSlotC,
                  goal);
  float Wa[3][N];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
      Wa[i][j] = M[i][0] * J[0][j] + M[i][1] * J[1][j] + M[i][2] * J[2][j];
#pragma unroll
  for (int jc = 0; jc < N; ++jc) {
    if (!act[jc]) continue;
    fs[jc] += J[0][jc] * u[0] + J[1][jc] * u[1] + J[2][jc] * u[2];
#pragma unroll
    for (int ic = jc; ic < N; ++ic) {
      if (!act[ic]) continue;
      A[ic][jc] += J[0][ic] * Wa[0][jc] + J[1][ic] * Wa[1][jc]
                   + J[2][ic] * Wa[2][jc];
    }
  }
}

// Identity-space leaf `kind` with its constants P, on the env's q and qd.
template <int N>
__device__ __forceinline__ void identity_leaf(float (&A)[N][N],
                                              float (&fs)[N], int kind,
                                              const float* __restrict__ P,
                                              const float* qb,
                                              const float* qdb) {
  if (kind == kVelCap) {
    const float cutoff = P[0], region = P[1], clip = P[2], wgt = P[3],
                gain = P[4];
    float a[N], m[N];
    float s_all = 0.0f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float v = qdb[j];
      const float dv = fabsf(v) - cutoff;
      a[j] = fabsf(v) < cutoff ? 0.0f : -fabsf(gain * dv) * sign_nan(v);
      const float ratio = min_nan(dv, clip) / region;
      m[j] = wgt / (1.0f - ratio * ratio);
      s_all = j == 0 ? a[0] : s_all + a[j];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      fs[i] += wgt * s_all + (m[i] - wgt) * a[i];
      A[i][i] += m[i] - wgt;
#pragma unroll
      for (int j = 0; j <= i; ++j) A[i][j] += wgt;
    }
  } else if (kind == kDamping) {
    float ss = qdb[0] * qdb[0];
#pragma unroll
    for (int j = 1; j < N; ++j) ss += qdb[j] * qdb[j];
    const float xdn = sqrtf(max_nan(ss, 1e-20f));
    const float e = P[0] * xdn + P[1];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      fs[j] += e * (-P[2] * xdn * qdb[j]);
      A[j][j] += e;
    }
  } else {  // kCspace
    const float thresh = P[0], pg = P[1], dg = P[2], e = P[3];
    float xs[N];
    float ss = 0.0f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      xs[j] = qb[j] - P[4 + j];
      ss = j == 0 ? xs[0] * xs[0] : ss + xs[j] * xs[j];
    }
    const float xn = sqrtf(max_nan(ss, 1e-24f));
    const float xn_safe = max_nan(xn, 1e-12f);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float a_pos = xn < thresh ? -xs[j] * pg
                                      : -thresh * (xs[j] / xn_safe) * pg;
      fs[j] += e * (a_pos - dg * qdb[j]);
      A[j][j] += e;
    }
  }
}

// The obstacle policy on one (collision frame, obstacle) pair: slot is the
// frame's, act its motors, rad its capsule's radius, b0 / b1 / rk the
// obstacle's segment ends and radius.
template <int N>
__device__ __forceinline__ void obstacle_pair(
    float (&A)[N][N], float (&fs)[N], const float* __restrict__ C,
    const float* slot, const int* anc, float rad, const float* b0,
    const float* b1, float rk) {
  float nh[3], metric, amc;
  obstacle_terms(nh, metric, amc, C, slot + kSlotPd, slot + kSlotC,
                 slot + slot_a0(N), slot + slot_a0(N) + 3, rad, b0, b1, rk);
  float Jd[N];
#pragma unroll
  for (int j = 0; j < N; ++j)
    Jd[j] = nh[0] * slot[kSlotJ + j] + nh[1] * slot[kSlotJ + N + j]
            + nh[2] * slot[kSlotJ + 2 * N + j];

#pragma unroll
  for (int jc = 0; jc < N; ++jc) {
    if (anc[jc] < 0) continue;
    fs[jc] += Jd[jc] * metric * amc;
    const float mj = metric * Jd[jc];
#pragma unroll
    for (int ic = jc; ic < N; ++ic) {
      if (anc[ic] < 0) continue;
      A[ic][jc] += Jd[ic] * mj;
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, 4) fused_qdd_kernel(
    int B, int F, int K, int n_col, int ee_frame, int n_ident,
    const int* __restrict__ parent, const int* __restrict__ joint_type,
    const int* __restrict__ q_index, const float* __restrict__ axis,
    const float* __restrict__ T_constant, const int* __restrict__ anc,
    const int* __restrict__ col_frames, const float* __restrict__ caps,
    const int* __restrict__ ident, const float* __restrict__ C,
    const float* __restrict__ q, const float* __restrict__ qd,
    const float* __restrict__ goal, const float* __restrict__ obs_p0,
    const float* __restrict__ obs_p1, const float* __restrict__ obs_r,
    float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L(F, N, n_col);
  int* imem = reinterpret_cast<int*>(smem + L.floats);
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kEnvs;
  const int nv = min(kEnvs, B - b0);  // envs of this tile

  // ---- the model's tables and the tile's q, qd ----
  for (int k = tid; k < 16 * F; k += kThreads) smem[L.Tc + k] = T_constant[k];
  for (int k = tid; k < F * N; k += kThreads) imem[L.anc + k] = anc[k];
  for (int k = tid; k < 7 * n_col; k += kThreads) smem[L.caps + k] = caps[k];
  for (int k = tid; k < kEnvs * N; k += kThreads) {
    // a masked env computes on the tile's last one
    const size_t at = static_cast<size_t>(b0 + min(k / N, nv - 1)) * N + k % N;
    smem[L.q + k] = q[at];
    smem[L.qd + k] = qd[at];
  }
  if (tid < 3 * F) smem[L.axis + tid] = axis[tid];
  if (tid < F) {
    imem[L.parent + tid] = parent[tid];
    imem[L.type + tid] = joint_type[tid];
    imem[L.qidx + tid] = q_index[tid];
  }
  if (tid < n_col) imem[L.colf + tid] = col_frames[tid];
  if (tid < 16) {
    smem[L.eye + tid] = (tid % 5 == 0) ? 1.0f : 0.0f;  // identity
    smem[L.eye + 16 + tid] = 0.0f;                      // zero
  }
  __syncthreads();

  // ---- per frame, once: the joint generators (per model) and the joint
  // motions (per env), transposed so the recursion reads columns as float4
  for (int k = tid; k < (kEnvs + 1) * F; k += kThreads) {
    const int e = k / F, f = k % F;  // e == kEnvs: the model's generator
    const int jt = imem[L.type + f];
    const float ax = smem[L.axis + 3 * f], ay = smem[L.axis + 3 * f + 1],
                az = smem[L.axis + 3 * f + 2];
    float m[16];
    if (e == kEnvs) {
      rmp::joint_generator(m, jt, ax, ay, az);
      rmp::store_transposed(smem + L.Et + 16 * f, m);
    } else {
      const int qi = imem[L.qidx + f];
      rmp::joint_motion(m, jt, ax, ay, az,
                        jt == rmp::kFixed ? 0.0f : smem[L.q + e * N + qi]);
      rmp::store_transposed(smem + L.U + e * L.ustride + 16 * f, m);
    }
  }
  __syncthreads();

  // ---- the recursion (fk_common.cuh): env e, lane r ----
  const int e = tid / kLanes;
  const int r = tid % kLanes;
  float* T = smem + L.T + e * L.tstride;
  float* W = smem + L.W + e * L.tstride;
  float* Cc = smem + L.C + e * L.tstride;
  float* G = smem + L.G + e * L.gstride;
  float* U = smem + L.U + e * L.ustride;
  const float* qb = smem + L.q + e * N;
  const float* qdb = smem + L.qd + e * N;
  const int* s_anc = imem + L.anc;
  const int* s_colf = imem + L.colf;
  rmp::fk_recursion(
      F, r,
      rmp::FkModel{imem + L.parent, imem + L.type, imem + L.qidx,
                   smem + L.Tc, smem + L.Et, smem + L.eye},
      rmp::FkArrays{T, nullptr, W, Cc, G, U + 16 * F, U, qdb});

  // ---- the point frames' slots, over the joint motions: row (u, i) ----
  float* slots = U;
  for (int it = r; it < 3 * (n_col + 1); it += kLanes) {
    const int u = it / 3, i = it - 3 * u;
    const int f = u == 0 ? ee_frame : s_colf[u - 1];
    frame_row<N>(slots + slot_floats(N) * u, i, f, T, W, Cc, G, s_anc,
                 u == 0 ? nullptr : smem + L.caps + 7 * (u - 1));
  }
  __syncwarp();

  // ---- work items: pairs, the attractor, the identity leaves ----
  const int b = b0 + min(e, nv - 1);
  float A[N][N];  // lower triangle
  float fs[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    fs[i] = 0.0f;
#pragma unroll
    for (int j = 0; j <= i; ++j) A[i][j] = (i == j && r == 0) ? C[kRidge] : 0.0f;
  }
  const int pairs = n_col * K;
  for (int it = r; it < pairs + 1 + n_ident; it += kLanes) {
    if (it < pairs) {
      const int li = it / K, k = it - li * K;
      const size_t o = static_cast<size_t>(b) * K + k;
      obstacle_pair<N>(A, fs, C, slots + slot_floats(N) * (1 + li),
                       s_anc + s_colf[li] * N, smem[L.caps + 7 * li + 6],
                       obs_p0 + 3 * o, obs_p1 + 3 * o, obs_r[o]);
    } else if (it == pairs) {
      attractor<N>(A, fs, C, slots, s_anc + ee_frame * N,
                   goal + static_cast<size_t>(b) * 3);
    } else {
      const int p = it - pairs - 1;
      identity_leaf<N>(A, fs, ident[2 * p], C + ident[2 * p + 1], qb, qdb);
    }
  }

  // ---- butterfly over the env's 16 lanes ----
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int off = kLanes / 2; off > 0; off /= 2)
      fs[i] += __shfl_xor_sync(0xffffffffu, fs[i], off);
#pragma unroll
    for (int j = 0; j <= i; ++j) {
#pragma unroll
      for (int off = kLanes / 2; off > 0; off /= 2)
        A[i][j] += __shfl_xor_sync(0xffffffffu, A[i][j], off);
    }
  }

  // ---- unrolled Cholesky of the symmetrized A, in place (lower) ---------
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < i; ++j) A[i][j] = 0.5f * (A[i][j] + A[i][j]);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float d = A[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) d = d - A[j][k] * A[j][k];
    const float Ljj = sqrtf(max_nan(d, 1e-12f));
    const float inv = 1.0f / Ljj;
    A[j][j] = Ljj;
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      float s = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - A[i][k] * A[j][k];
      A[i][j] = s * inv;
    }
  }
  float y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = fs[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - A[i][k] * y[k];
    y[i] = s / A[i][i];
  }
  float xs[N];
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) s = s - A[k][i] * xs[k];
    xs[i] = s / A[i][i];
  }
  if (r == 0 && e < nv) {
#pragma unroll
    for (int i = 0; i < N; ++i) out[static_cast<size_t>(b) * N + i] = xs[i];
  }
}

template <int N>
void launch(const rmp_k5::NarrowLaunch& a) {
  const int bytes = Layout(a.F, N, a.n_col).bytes();
  if (bytes > 48 * 1024)  // above the default: opt in (up to 227 KB)
    cudaFuncSetAttribute(fused_qdd_kernel<N>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const int blocks = (a.B + kEnvs - 1) / kEnvs;
  fused_qdd_kernel<N><<<blocks, kThreads, bytes, a.stream>>>(
      a.B, a.F, a.K, a.n_col, a.ee_frame, a.n_ident, a.parent, a.joint_type,
      a.q_index, a.axis, a.T_constant, a.anc, a.col_frames, a.caps, a.ident,
      a.consts, a.q, a.qd, a.goal, a.obs_p0, a.obs_p1, a.obs_r, a.out);
}

// launch<N> for the run-time n = N, N + 1, ..., Hi: each source file that
// includes this header instantiates the kernel for its own range of n
template <int N, int Hi>
void launch_range(int n, const rmp_k5::NarrowLaunch& a) {
  if (n == N) {
    launch<N>(a);
  } else if constexpr (N < Hi) {
    launch_range<N + 1, Hi>(n, a);
  }
}

}  // namespace
