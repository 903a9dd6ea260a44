// K5, wide: the fused v2 tick past the 16-lane kernel's reach, a warp per
// environment.
//
// Replaces the TPU kernel rmp_tpu/ops/pallas_tick.py::make_fused_qdd
// (_make_kernel, _seg_closest), which takes any model.n_q, for the models
// that fused_tick.cu's 16 lanes an env refuse: up to kMaxN = 32 motors,
// kMaxFrames = 40 frames and kMaxCollision = 40 collision frames (K1's and
// K3's reach; the planar arms of 17 to 32 links, F = n + 1, n + 1
// collision frames). The function and its semantics are fused_tick.cu's
// (its header lists them); the policy arithmetic both kernels share is in
// fused_policy.cuh. Plain version: ops/cuda_tick.fused_qdd_plain.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32): operations. At the
// 32-link arm (F = 33, one obstacle) an env reads 2n + 3 + 7 floats and
// writes n, 424 B, but the reference body does ~57,000 operations
// (ops/tick_ops.fused_qdd_ops, A's mirrored half left out): the Cholesky
// alone ~n^3 / 3 = 11,000. At B = 4096 the bound is ~3.5 us.
//
// Design, after K1's pullback_resolve_wide_kernel (a warp an env,
// elimination by shuffles) and K3's wide tile (the recursion's arrays in
// shared memory, 4 envs a CTA):
// - A CTA takes kEnvs = 4 consecutive envs, a warp each (128 threads); the
//   last tile computes on its last env and stores nothing for the rest.
// - The model's tables and the tile's q, qd go to shared memory, as in
//   fused_tick.cu, with a bitmask per frame of the motors that drive it
//   (act); the joint motions and generators are made once per (env, frame)
//   in a prologue.
// - The recursion (fk_common.cuh) runs on 16 lanes an env as in K3: the
//   tile's 4 envs on the CTA's first two warps, the other two wait at the
//   barrier. T, W, C and G of every frame stay in shared memory: ~13 KB an
//   env at 33 frames, 75 KB a CTA at the 40-frame capacity, 3 CTAs (12
//   envs) an SM.
// - A has a row per lane: lane r keeps row r of A (N floats) and f_r in
//   registers, and every entry is one sum in the plain version's order:
//   the ridge, the attractor, the identity leaves, then the pairs frame by
//   frame. The attractor: every lane forms M and u (attractor_terms), lane
//   c the EE's Jacobian column c and (M J)_c, staged; lane r adds
//   J_r . (M J)_c to its row for every c. An identity leaf: each lane its
//   row. The pairs: 32 at once, a lane each, run obstacle_terms and stage
//   (n_h, metric, a - c); then pair by pair lane c forms u_c = n_h . J_c
//   (J_c from the generators, made once per frame) and stages metric u_c;
//   lane r adds u_r metric u_c to every entry of its row (a motor that does
//   not drive the frame has u = 0 exactly, and its row is skipped).
// - The Cholesky by shuffles, right-looking: at column j lane j's pivot
//   square is broadcast, the lanes below scale their entry, and column j's
//   entries are broadcast one by one into the trailing rows, so each entry
//   subtracts its products in the 16-lane kernel's order. The forward
//   substitution likewise; the back substitution runs on every lane from
//   L's columns broadcast entry by entry, in the reference's order.
// - n is padded to the instantiation's N (24 for n <= 24, else 32): the
//   rows past n are the identity with f = 0, which leaves the arithmetic
//   of the first n rows exactly what an instantiation at N = n would do.
#include <cuda_runtime.h>

#include "fk_common.cuh"
#include "fused_policy.cuh"

namespace {

using namespace rmp;

constexpr int kMaxFrames = 40;
constexpr int kMaxN = 32;
constexpr int kMaxCollision = 40;
constexpr int kMaxIdentity = 8;
constexpr int kEnvs = 4;                // warps per CTA, an env each
constexpr int kThreads = 32 * kEnvs;
constexpr int kPairStride = 8;          // floats of a staged pair's terms
constexpr unsigned kAll = 0xffffffffu;

// A point frame's slot: origin p, velocity pd, curvature c and, for a
// collision frame, its first capsule's ends a0, a1 in world coordinates.
constexpr int kSlotP = 0, kSlotPd = 3, kSlotC = 6, kSlotA0 = 9, kSlotA1 = 12;
constexpr int kSlotFloats = 15;

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Float offsets of the shared-memory arrays, then the int tables. Per env:
// T, W, C (Wd, then Wd + W W) at env stride `tstride`, the generators at
// pitch kGPitch and stride `gstride`, a union region at stride `ustride`
// (the joint motions' transposes and the recursion's scratch, then the
// n_col + 1 frame slots), and the staging region at `estride`: 32 pairs'
// terms, then 3 x 32 floats of rows (the attractor's M J, the pairs' two
// buffers of metric u). Per model: Tc, Et, the identity and zero matrices,
// the axes, the capsules; per env q and qd. Ints: parent, joint type, motor
// index, the ancestor table (F x n), each frame's motor bitmask and the
// collision frames.
struct Layout {
  int tstride, gstride, ustride, estride;
  int T, W, C, G, U, E, Tc, Et, eye, axis, caps, q, qd, floats;
  int parent, type, qidx, anc, act, colf, ints;
  __host__ __device__ constexpr Layout(int F, int n, int n_col)
      : tstride(odd_half(16 * F)), gstride(odd_half(kGPitch * F)),
        ustride(odd_half(imax(16 * F + 48, kSlotFloats * (n_col + 1)))),
        estride(32 * kPairStride + 3 * 32),
        T(0), W(kEnvs * tstride), C(2 * kEnvs * tstride),
        G(3 * kEnvs * tstride), U(G + kEnvs * gstride),
        E(U + kEnvs * ustride), Tc(E + kEnvs * estride), Et(Tc + 16 * F),
        eye(Et + 16 * F), axis(eye + 32), caps(axis + 3 * F),
        q(caps + 7 * n_col), qd(q + kEnvs * n), floats(qd + kEnvs * n),
        parent(0), type(F), qidx(2 * F), anc(3 * F), act(anc + F * n),
        colf(act + F), ints(colf + n_col) {}
  __host__ __device__ constexpr int bytes() const {
    return 4 * (floats + ints);
  }
};

// J's column of motor j (a generator index, -1: the motor does not drive
// the frame) at the origin of the frame whose transform is Tf.
__device__ __forceinline__ void jacobian_column(float (&J)[3],
                                                const float* G,
                                                const float* Tf, int j) {
  const float ph0 = Tf[3], ph1 = Tf[7], ph2 = Tf[11];
  const float* Gj = G + kGPitch * (j < 0 ? 0 : j);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    J[i] = j >= 0 ? Gj[4 * i] * ph0 + Gj[4 * i + 1] * ph1
                        + Gj[4 * i + 2] * ph2 + Gj[4 * i + 3]
                  : 0.0f;
}

// row[c] += v where c == lane (the diagonal of the lane's row).
template <int N>
__device__ __forceinline__ void add_diagonal(float (&row)[N], int lane,
                                             float v) {
#pragma unroll
  for (int c = 0; c < N; ++c)
    if (c == lane) row[c] += v;
}

// Identity-space leaf `kind` with its constants P on row `lane` (< n) of
// [A | f], over the env's n joints.
template <int N>
__device__ __forceinline__ void identity_row(float (&row)[N], float& fr,
                                             int kind,
                                             const float* __restrict__ P,
                                             const float* qb,
                                             const float* qdb, int n,
                                             int lane) {
  if (kind == kVelCap) {
    const float cutoff = P[0], region = P[1], clip = P[2], wgt = P[3],
                gain = P[4];
    float s_all = 0.0f, ar = 0.0f, mr = 0.0f;
    for (int j = 0; j < n; ++j) {
      const float v = qdb[j];
      const float dv = fabsf(v) - cutoff;
      const float a = fabsf(v) < cutoff ? 0.0f
                                        : -fabsf(gain * dv) * sign_nan(v);
      s_all = j == 0 ? a : s_all + a;
      if (j == lane) {
        const float ratio = min_nan(dv, clip) / region;
        ar = a;
        mr = wgt / (1.0f - ratio * ratio);
      }
    }
    fr += wgt * s_all + (mr - wgt) * ar;
#pragma unroll
    for (int c = 0; c < N; ++c) {
      if (c == lane) row[c] += mr - wgt;
      if (c <= lane) row[c] += wgt;
    }
  } else if (kind == kDamping) {
    float ss = qdb[0] * qdb[0];
    for (int j = 1; j < n; ++j) ss += qdb[j] * qdb[j];
    const float xdn = sqrtf(max_nan(ss, 1e-20f));
    const float e = P[0] * xdn + P[1];
    fr += e * (-P[2] * xdn * qdb[lane]);
    add_diagonal(row, lane, e);
  } else {  // kCspace
    const float thresh = P[0], pg = P[1], dg = P[2], e = P[3];
    float ss = 0.0f, xr = 0.0f;
    for (int j = 0; j < n; ++j) {
      const float xs = qb[j] - P[4 + j];
      ss = j == 0 ? xs * xs : ss + xs * xs;
      if (j == lane) xr = xs;
    }
    const float xn = sqrtf(max_nan(ss, 1e-24f));
    const float xn_safe = max_nan(xn, 1e-12f);
    const float a_pos = xn < thresh ? -xr * pg : -thresh * (xr / xn_safe) * pg;
    fr += e * (a_pos - dg * qdb[lane]);
    add_diagonal(row, lane, e);
  }
}

// row[c] += u * x[c] for every c, x a staged row of N floats.
template <int N>
__device__ __forceinline__ void add_scaled(float (&row)[N], float u,
                                           const float* x) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
#pragma unroll
  for (int c = 0; c < N; c += 4) {
    const float4 v = x4[c / 4];
    row[c] += u * v.x;
    row[c + 1] += u * v.y;
    row[c + 2] += u * v.z;
    row[c + 3] += u * v.w;
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, 3) fused_qdd_wide_kernel(
    int B, int F, int n, int K, int n_col, int ee_frame, int n_ident,
    const int* __restrict__ parent, const int* __restrict__ joint_type,
    const int* __restrict__ q_index, const float* __restrict__ axis,
    const float* __restrict__ T_constant, const int* __restrict__ anc,
    const int* __restrict__ col_frames, const float* __restrict__ caps,
    const int* __restrict__ ident, const float* __restrict__ C,
    const float* __restrict__ q, const float* __restrict__ qd,
    const float* __restrict__ goal, const float* __restrict__ obs_p0,
    const float* __restrict__ obs_p1, const float* __restrict__ obs_r,
    float* __restrict__ out) {
  static_assert(N % 4 == 0 && N <= 32, "rows of float4s, a lane each");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L(F, n, n_col);
  int* imem = reinterpret_cast<int*>(smem + L.floats);
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kEnvs;
  const int nv = min(kEnvs, B - b0);  // envs of this tile

  // ---- the model's tables and the tile's q, qd ----
  for (int k = tid; k < 16 * F; k += kThreads) smem[L.Tc + k] = T_constant[k];
  for (int k = tid; k < F * n; k += kThreads) imem[L.anc + k] = anc[k];
  for (int k = tid; k < 7 * n_col; k += kThreads) smem[L.caps + k] = caps[k];
  for (int k = tid; k < kEnvs * n; k += kThreads) {
    // a masked env computes on the tile's last one
    const size_t at = static_cast<size_t>(b0 + min(k / n, nv - 1)) * n + k % n;
    smem[L.q + k] = q[at];
    smem[L.qd + k] = qd[at];
  }
  for (int k = tid; k < 3 * F; k += kThreads) smem[L.axis + k] = axis[k];
  for (int k = tid; k < F; k += kThreads) {
    imem[L.parent + k] = parent[k];
    imem[L.type + k] = joint_type[k];
    imem[L.qidx + k] = q_index[k];
    unsigned bits = 0u;
    for (int m = 0; m < n; ++m)
      bits |= (anc[k * n + m] >= 0 ? 1u : 0u) << m;
    imem[L.act + k] = static_cast<int>(bits);
  }
  for (int k = tid; k < n_col; k += kThreads) imem[L.colf + k] = col_frames[k];
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
      joint_generator(m, jt, ax, ay, az);
      store_transposed(smem + L.Et + 16 * f, m);
    } else {
      const int qi = imem[L.qidx + f];
      joint_motion(m, jt, ax, ay, az,
                   jt == kFixed ? 0.0f : smem[L.q + e * n + qi]);
      store_transposed(smem + L.U + e * L.ustride + 16 * f, m);
    }
  }
  __syncthreads();

  // ---- the recursion on 16 lanes an env: the first two warps ----
  if (tid < 16 * kEnvs) {
    const int e = tid / 16;
    float* U = smem + L.U + e * L.ustride;
    fk_recursion(
        F, tid % 16,
        FkModel{imem + L.parent, imem + L.type, imem + L.qidx, smem + L.Tc,
                smem + L.Et, smem + L.eye},
        FkArrays{smem + L.T + e * L.tstride, nullptr,
                 smem + L.W + e * L.tstride, smem + L.C + e * L.tstride,
                 smem + L.G + e * L.gstride, U + 16 * F, U,
                 smem + L.qd + e * n});
  }
  __syncthreads();

  // ---- a warp an env from here on ----
  const int e = tid >> 5;
  const int lane = tid & 31;
  const float* T = smem + L.T + e * L.tstride;
  const float* W = smem + L.W + e * L.tstride;
  const float* Cc = smem + L.C + e * L.tstride;
  const float* G = smem + L.G + e * L.gstride;
  float* slots = smem + L.U + e * L.ustride;
  float* stage = smem + L.E + e * L.estride;
  float* V = stage + 32 * kPairStride;
  const float* qb = smem + L.q + e * n;
  const float* qdb = smem + L.qd + e * n;
  const int* s_anc = imem + L.anc;
  const int* s_act = imem + L.act;
  const int* s_colf = imem + L.colf;
  const int b = b0 + min(e, nv - 1);
  const bool real = lane < n;

  // the point frames' slots, row (u, i) on lane (3 u + i) mod 32
  for (int it = lane; it < 3 * (n_col + 1); it += 32) {
    const int u = it / 3, i = it - 3 * u;
    const int f = u == 0 ? ee_frame : s_colf[u - 1];
    float* slot = slots + kSlotFloats * u;
    const float* Tf = T + 16 * f;
    const float ph0 = Tf[3], ph1 = Tf[7], ph2 = Tf[11];
    const float* Wf = W + 16 * f + 4 * i;
    const float* Cf = Cc + 16 * f + 4 * i;
    slot[kSlotP + i] = Tf[4 * i + 3];
    slot[kSlotPd + i] = Wf[0] * ph0 + Wf[1] * ph1 + Wf[2] * ph2 + Wf[3];
    slot[kSlotC + i] = Cf[0] * ph0 + Cf[1] * ph1 + Cf[2] * ph2 + Cf[3];
    if (u > 0) {
      const float* cap = smem + L.caps + 7 * (u - 1);
      const float* Ti = Tf + 4 * i;
      slot[kSlotA0 + i] =
          Ti[0] * cap[0] + Ti[1] * cap[1] + Ti[2] * cap[2] + Ti[3];
      slot[kSlotA1 + i] =
          Ti[0] * cap[3] + Ti[1] * cap[4] + Ti[2] * cap[5] + Ti[3];
    }
  }
  __syncwarp();

  // row `lane` of [A | f]: the ridge; the padded rows the identity
  float row[N];
#pragma unroll
  for (int c = 0; c < N; ++c)
    row[c] = c == lane ? (real ? C[kRidge] : 1.0f) : 0.0f;
  float fr = 0.0f;

  // ---- the attractor on the EE position ----
  {
    float M[3][3], u[3], J[3];
    attractor_terms(M, u, C, slots + kSlotP, slots + kSlotPd, slots + kSlotC,
                    goal + static_cast<size_t>(b) * 3);
    jacobian_column(J, G, T + 16 * ee_frame,
                    real ? s_anc[ee_frame * n + lane] : -1);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      V[32 * i + lane] = M[i][0] * J[0] + M[i][1] * J[1] + M[i][2] * J[2];
    __syncwarp();
    if ((static_cast<unsigned>(s_act[ee_frame]) >> lane) & 1u) {
      fr += J[0] * u[0] + J[1] * u[1] + J[2] * u[2];
      const float4* w0 = reinterpret_cast<const float4*>(V);
      const float4* w1 = reinterpret_cast<const float4*>(V + 32);
      const float4* w2 = reinterpret_cast<const float4*>(V + 64);
#pragma unroll
      for (int c = 0; c < N; c += 4) {
        const float4 a = w0[c / 4], bb = w1[c / 4], cc = w2[c / 4];
        row[c] += J[0] * a.x + J[1] * bb.x + J[2] * cc.x;
        row[c + 1] += J[0] * a.y + J[1] * bb.y + J[2] * cc.y;
        row[c + 2] += J[0] * a.z + J[1] * bb.z + J[2] * cc.z;
        row[c + 3] += J[0] * a.w + J[1] * bb.w + J[2] * cc.w;
      }
    }
    __syncwarp();
  }

  // ---- the identity-space leaves, in policy order ----
  for (int p = 0; p < n_ident; ++p)
    if (real)
      identity_row(row, fr, ident[2 * p], C + ident[2 * p + 1], qb, qdb, n,
                   lane);

  // ---- the pairs, frame by frame, 32 staged at a time ----
  const int pairs = n_col * K;
  int cur = -1;
  unsigned act = 0u;
  float J[3] = {0.0f, 0.0f, 0.0f};
  int buf = 0;
  for (int base = 0; base < pairs; base += 32) {
    __syncwarp();  // the previous batch's terms are read
    const int pp = base + lane;
    if (pp < pairs) {
      const int li = pp / K, k = pp - li * K;
      const float* slot = slots + kSlotFloats * (1 + li);
      const size_t o = static_cast<size_t>(b) * K + k;
      float nh[3], metric, amc;
      obstacle_terms(nh, metric, amc, C, slot + kSlotPd, slot + kSlotC,
                     slot + kSlotA0, slot + kSlotA1,
                     smem[L.caps + 7 * li + 6], obs_p0 + 3 * o,
                     obs_p1 + 3 * o, obs_r[o]);
      float* st = stage + kPairStride * lane;
      st[0] = nh[0];
      st[1] = nh[1];
      st[2] = nh[2];
      st[3] = metric;
      st[4] = amc;
    }
    __syncwarp();
    const int count = min(32, pairs - base);
    for (int j = 0; j < count; ++j) {
      const int li = (base + j) / K;
      if (li != cur) {  // warp-uniform: a new collision frame
        cur = li;
        const int f = s_colf[li];
        act = static_cast<unsigned>(s_act[f]);
        jacobian_column(J, G, T + 16 * f, real ? s_anc[f * n + lane] : -1);
      }
      const float4 t = *reinterpret_cast<const float4*>(stage
                                                        + kPairStride * j);
      const float amc = stage[kPairStride * j + 4];
      const float uc = t.x * J[0] + t.y * J[1] + t.z * J[2];  // Jd[lane]
      float* mu = V + 32 * buf;
      mu[lane] = t.w * uc;                                   // metric Jd
      __syncwarp();
      if ((act >> lane) & 1u) {
        fr += uc * t.w * amc;
        add_scaled(row, uc, mu);
      }
      buf ^= 1;
    }
  }

  // ---- Cholesky of the symmetrized A, right-looking, by shuffles ----
#pragma unroll
  for (int c = 0; c < N; ++c)
    if (c < lane) row[c] = 0.5f * (row[c] + row[c]);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float d = __shfl_sync(kAll, row[j], j);
    const float Ljj = sqrtf(max_nan(d, 1e-12f));
    const float inv = 1.0f / Ljj;
    row[j] = lane == j ? Ljj : row[j] * inv;  // L's column j below
#pragma unroll
    for (int k = j + 1; k < N; ++k) {
      const float lkj = __shfl_sync(kAll, row[j], k);
      if (lane >= k) row[k] = row[k] - row[j] * lkj;
    }
  }
  // L y = f: y broadcast to every lane
  float y[N];
  float s = fr;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    y[k] = __shfl_sync(kAll, s / row[k], k);
    s = s - row[k] * y[k];
  }
  // L^T x = y on every lane, x over y
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float t = y[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) t = t - __shfl_sync(kAll, row[i], k) * y[k];
    y[i] = t / __shfl_sync(kAll, row[i], i);
  }
  float mine = 0.0f;
#pragma unroll
  for (int c = 0; c < N; ++c)
    if (c == lane) mine = y[c];
  if (real && e < nv) out[static_cast<size_t>(b) * n + lane] = mine;
}

template <int N>
void launch(int B, int F, int n, int K, int n_col, int ee_frame, int n_ident,
            const int* parent, const int* joint_type, const int* q_index,
            const float* axis, const float* T_constant, const int* anc,
            const int* col_frames, const float* caps, const int* ident,
            const float* consts, const float* q, const float* qd,
            const float* goal, const float* obs_p0, const float* obs_p1,
            const float* obs_r, float* out, cudaStream_t stream) {
  const int bytes = Layout(F, n, n_col).bytes();
  if (bytes > 48 * 1024)  // above the default: opt in (up to 227 KB)
    cudaFuncSetAttribute(fused_qdd_wide_kernel<N>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const int blocks = (B + kEnvs - 1) / kEnvs;
  fused_qdd_wide_kernel<N><<<blocks, kThreads, bytes, stream>>>(
      B, F, n, K, n_col, ee_frame, n_ident, parent, joint_type, q_index,
      axis, T_constant, anc, col_frames, caps, ident, consts, q, qd, goal,
      obs_p0, obs_p1, obs_r, out);
}

}  // namespace

// Dynamic shared memory of one CTA for a model of F frames, n motors and
// n_col collision frames.
extern "C" int rmp_fused_qdd_wide_shared_bytes(int F, int n, int n_col) {
  return Layout(F, n, n_col).bytes();
}

// Launches on `stream` of GPU `device` (the caller's current device is
// restored); the arguments are rmp_fused_qdd_f32's. Returns
// cudaGetLastError() after the launch, or -1 when the model or env exceeds
// the kernel's capacity (1 to kMaxN motors, up to kMaxFrames frames,
// kMaxCollision collision frames and kMaxIdentity identity-space leaves;
// nothing is launched then).
extern "C" int rmp_fused_qdd_wide_f32(
    int device, int B, int F, int n, int K, int n_col, int ee_frame,
    int n_ident, const int* parent, const int* joint_type,
    const int* q_index, const float* axis, const float* T_constant,
    const int* anc, const int* col_frames, const float* caps,
    const int* ident, const float* consts, const float* q, const float* qd,
    const float* goal, const float* obs_p0, const float* obs_p1,
    const float* obs_r, float* out, void* stream) {
  if (n < 1 || n > kMaxN || F > kMaxFrames || n_col > kMaxCollision ||
      n_ident > kMaxIdentity)
    return -1;
  if (B <= 0) return 0;
  int previous = device;
  cudaGetDevice(&previous);
  if (previous != device) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  if (n <= 24)
    launch<24>(B, F, n, K, n_col, ee_frame, n_ident, parent, joint_type,
               q_index, axis, T_constant, anc, col_frames, caps, ident,
               consts, q, qd, goal, obs_p0, obs_p1, obs_r, out,
               static_cast<cudaStream_t>(stream));
  else
    launch<32>(B, F, n, K, n_col, ee_frame, n_ident, parent, joint_type,
               q_index, axis, T_constant, anc, col_frames, caps, ident,
               consts, q, qd, goal, obs_p0, obs_p1, obs_r, out,
               static_cast<cudaStream_t>(stream));
  const int rc = static_cast<int>(cudaGetLastError());
  if (previous != device) cudaSetDevice(previous);
  return rc;
}
