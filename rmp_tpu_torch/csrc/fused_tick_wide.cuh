// K5's wide kernel: the fused v2 tick for the models past fused_tick.cu's
// 16 lanes an env, up to kMaxN = 32 motors, kMaxFrames = 40 frames and
// kMaxCollision = 40 collision frames (the planar arms of 17 to 32 links,
// F = n + 1, n + 1 collision frames; trees in topological order).
//
// Replaces the TPU kernel rmp_tpu/ops/pallas_tick.py::make_fused_qdd
// (_make_kernel, _seg_closest), which takes any model.n_q, for those
// models. The function and its semantics are fused_tick.cu's (its head
// note lists them); the policy arithmetic both kernels share is in
// fused_policy.cuh. Plain version: ops/cuda_tick.fused_qdd_plain.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32): operations. At the
// 32-link arm (F = 33, one obstacle) an env reads 2n + 3 + 7 floats and
// writes n, 424 B, but the reference body does 49,663 operations
// (ops/tick_ops.fused_qdd_ops, A's mirrored half left out): 3.0 us at
// B = 4096. The kernel is bound by its dependent chains (33 frame steps in
// sequence, a 32-step factorisation, a 32-step back substitution), so its
// job is to keep enough envs on each SM that their chains overlap.
//
// Design.
// - A half warp an env (lane r), kEnvs = 8 envs a CTA, and no barrier
//   wider than a warp: each env runs its own chain, and an SM's 16 warps
//   interleave one env's frame steps with another's pairs or solve.
// - The model's tables are read through the read-only cache (each frame's
//   a step ahead), never copied per CTA; q, qd, sin q and cos q of motors
//   r and r + 16 sit on lane r and reach a frame's step by __shfl_sync.
// - The recursion is K3's wide one (fk_derivatives_wide.cuh): lane r owns
//   entry (r / 4, r % 4) of each 4x4 product, and every frame keeps only
//   rows 0-2 of T, W, Wd and G (row 3 is exact constants): 48 floats a
//   frame. At F = 33 an env holds 7.1 KB, so 32 envs fit an SM and 4096
//   envs take one wave.
// - A point frame's origin terms (position, velocity, curvature, the
//   capsule's world ends) are formed where they are used, from its T, W
//   and Wd rows: the EE's on every lane for the attractor, a collision
//   frame's by the lane that runs its pair.
// - A lives in registers, two rows a lane: row r's columns 0-15 (all of its
//   lower triangle) and row r + 16's columns 0..N-1, with the diagonal
//   apart (dA, dB) and f beside. Every entry is one sum in the 16-lane
//   kernel's order: the ridge, the attractor, the identity leaves in policy
//   order, then the pairs frame by frame. The pairs run 16 at a time, a
//   lane each, through obstacle_terms; then pair by pair each lane forms
//   the Jacobian columns of its two motors (from the ancestors' G, once a
//   frame), stages metric u for them, and adds u_r metric u_c to its rows;
//   a motor that does not drive the frame has u = 0 exactly and its row is
//   skipped. An identity leaf's sums over the motors run by xor shuffles
//   (another order than the reference's left-to-right one).
// - Cholesky, right-looking: at column j the pivot square and f_j are
//   broadcast from their lane, each lane scales its entries of column j
//   and writes them to shared memory, and the trailing entries subtract
//   l_rj l_kj with l_kj read back as broadcast float4s (a shuffle per entry
//   before). The diagonal is updated from the lane's own entries, so the
//   next pivot waits on no shared-memory round trip. The forward
//   substitution is folded in (f_r -= l_rj y_j, y_j = f_j / l_jj).
// - The back substitution is a column sweep: L's rows go to shared memory
//   over the dead frame arrays, x_i is broadcast from its lane, and every
//   lane subtracts l_ir x_i from its two sums: the products are subtracted
//   from the last row up, where the reference adds them from the first.
// - n is padded to the instantiation's N (24 for n <= 24, else 32): the
//   rows past n are the identity with f = 0, which leaves the arithmetic of
//   the first n rows what an instantiation at N = n would do.
#pragma once

#include <cuda_runtime.h>

#include "fk_common.cuh"
#include "fk_derivatives_wide.cuh"
#include "fused_policy.cuh"

namespace rmp_k5 {

using rmp::col4;
using rmp::dot4;
using rmp::ld4;
using rmp::max_nan;
using rmp::min_nan;
using rmp::sign_nan;
using rmp_k3::col3;
using rmp_k3::generator_col;
using rmp_k3::motion_col;

constexpr int kMaxFrames = 40;
constexpr int kMaxN = 32;
constexpr int kMaxCollision = 40;
constexpr int kMaxIdentity = 8;
constexpr int kEnvs = 8;               // envs a CTA, a half warp each
constexpr int kThreads = 16 * kEnvs;
constexpr int kRows3 = 12;             // floats of rows 0-2 of a 4x4
constexpr int kPairStride = 8;         // a staged pair: nh, metric, a - c, origin
constexpr unsigned kAll = 0xffffffffu;

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Float offsets within an env's block of shared memory (envs `stride`
// floats apart, 16 mod 32, so the two envs of a warp read the same entry
// from opposite halves of the banks). The frames' rows 0-2 of T, W, Wd and
// G, then a work region that each phase uses in turn: the recursion's
// identity and zero matrices and its A, A E, A^-1; the attractor's M J
// rows (3 x 32); the pairs' 16 staged terms and two buffers of metric u;
// the factorisation's two column buffers. L's rows for the back
// substitution (N at pitch N + 4) lie over the frames, dead by then.
struct Layout {
  int T, W, D, G, work, eye, zero, sA, sAE, sAinv, V, stage, mu, col, Lrow,
      pitch, stride;
  __host__ __device__ constexpr Layout(int F, int N)
      : T(0), W(kRows3 * F), D(2 * kRows3 * F), G(3 * kRows3 * F),
        work(4 * kRows3 * F), eye(work), zero(work + 16), sA(work + 32),
        sAE(work + 48), sAinv(work + 64), V(work), stage(work),
        mu(work + 16 * kPairStride), col(work), Lrow(0), pitch(N + 4),
        stride(rmp::odd_half(imax(work + 16 * kPairStride + 64,
                                  N * (N + 4)))) {}
  __host__ __device__ constexpr int bytes() const {
    return 4 * kEnvs * stride;
  }
};

// A frame's model entries, read a frame ahead of its step.
struct FrameTab {
  int parent, type, qidx;
  float ax, ay, az;
  float4 tc;  // column j of the constant transform
};

__device__ __forceinline__ FrameTab frame_tab(
    int f, int j, const int* __restrict__ parent,
    const int* __restrict__ joint_type, const int* __restrict__ q_index,
    const float* __restrict__ axis, const float* __restrict__ T_constant) {
  const float* tc = T_constant + 16 * f + j;
  FrameTab t;
  t.parent = __ldg(parent + f);
  t.type = __ldg(joint_type + f);
  t.qidx = __ldg(q_index + f);
  t.ax = __ldg(axis + 3 * f);
  t.ay = __ldg(axis + 3 * f + 1);
  t.az = __ldg(axis + 3 * f + 2);
  t.tc = make_float4(__ldg(tc), __ldg(tc + 4), __ldg(tc + 8), __ldg(tc + 12));
  return t;
}

// The origin of a frame from its rows 0-2 of T, W and Wd: position ph,
// velocity pd = (W ph)_xyz and curvature cx = ((Wd + W W) ph)_xyz, each in
// the 16-lane kernel's order (Wd + W W formed first, by dot4).
__device__ __forceinline__ void origin_terms(float (&ph)[3], float (&pd)[3],
                                             float (&cx)[3], const float* T,
                                             const float* W, const float* D) {
#pragma unroll
  for (int a = 0; a < 3; ++a) ph[a] = T[4 * a + 3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float* Wa = W + 4 * a;
    pd[a] = Wa[0] * ph[0] + Wa[1] * ph[1] + Wa[2] * ph[2] + Wa[3];
    const float4 wrow = ld4(Wa);
    float c[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      c[k] = dot4(wrow, col3(W, k, 0.0f)) + D[4 * a + k];
    cx[a] = c[0] * ph[0] + c[1] * ph[1] + c[2] * ph[2] + c[3];
  }
}

// J's column of the motor whose generator is frame g's (-1: the motor does
// not drive the frame) at the frame origin ph.
__device__ __forceinline__ void jacobian_column(float (&J)[3], const float* G,
                                                int g, const float* ph) {
  const float* Gg = G + kRows3 * (g < 0 ? 0 : g);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float4 row = ld4(Gg + 4 * a);
    J[a] = g >= 0 ? row.x * ph[0] + row.y * ph[1] + row.z * ph[2] + row.w
                  : 0.0f;
  }
}

// Σ over the env's 16 lanes (xor shuffles within the half warp).
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(kAll, v, off);
  return v;
}

// row[c] += u * x[c] for c < M, x a staged row (16-byte aligned).
template <int M>
__device__ __forceinline__ void add_scaled(float (&row)[M], float u,
                                           const float* x) {
#pragma unroll
  for (int c = 0; c < M; c += 4) {
    const float4 v = ld4(x + c);
    row[c] += u * v.x;
    row[c + 1] += u * v.y;
    row[c + 2] += u * v.z;
    row[c + 3] += u * v.w;
  }
}

// The velocity cap's share of one motor's row: its off-diagonal entries
// below column `below`, its diagonal d and f; wgt: the cap's weight, a, m:
// the motor's acceleration and metric, s_all: Σ a over the env's motors.
template <int M>
__device__ __forceinline__ void velcap_row(float (&row)[M], float& d,
                                           float& f, int below, float wgt,
                                           float a, float m, float s_all) {
  f += wgt * s_all + (m - wgt) * a;
  d += m - wgt;
  d += wgt;
#pragma unroll
  for (int c = 0; c < M; ++c)
    if (c < below) row[c] += wgt;
}

template <int N>
__global__ void __launch_bounds__(kThreads, 4) fused_qdd_wide_kernel(
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
  static_assert(N > 16 && N <= kMaxN && N % 4 == 0,
                "rows r and r + 16 on lane r, float4 groups");
  extern __shared__ float4 smem4[];
  const Layout L(F, N);
  const int tid = threadIdx.x;
  const int r = tid & 15, i = r >> 2, j = r & 3;
  const bool row3 = i == 3;     // entries (3, j): constants, kept nowhere
  const int ir = row3 ? 0 : i;  // a row that exists, for their loads
  const int half = tid & 16;    // the half warp's first lane in its warp
  const int slot = blockIdx.x * kEnvs + (tid >> 4);
  const bool live = slot < B;
  const int b = live ? slot : B - 1;  // a masked env computes on the last
  float* s = reinterpret_cast<float*>(smem4) + (tid >> 4) * L.stride;
  const bool realA = r < n, realB = r + 16 < n;  // motors r, r + 16

  // ---- the env's q, qd (motor r and r + 16 on lane r), sin q, cos q ----
  const size_t o = static_cast<size_t>(b) * n;
  const float qA = realA ? q[o + r] : 0.0f;
  const float qdA = realA ? qd[o + r] : 0.0f;
  const float qB = realB ? q[o + r + 16] : 0.0f;
  const float qdB = realB ? qd[o + r + 16] : 0.0f;
  float sinA, cosA, sinB, cosB;
  sincosf(qA, &sinA, &cosA);
  sincosf(qB, &sinB, &cosB);
  s[L.eye + r] = (r % 5 == 0) ? 1.0f : 0.0f;
  s[L.zero + r] = 0.0f;
  FrameTab next = frame_tab(0, j, parent, joint_type, q_index, axis,
                            T_constant);
  __syncwarp();

  // ---- the frames, in topological order ----
  for (int f = 0; f < F; ++f) {
    const FrameTab tab = next;
    if (f + 1 < F)
      next = frame_tab(f + 1, j, parent, joint_type, q_index, axis,
                       T_constant);
    const int p = tab.parent, jt = tab.type;
    const int qs = tab.qidx < 0 ? 0 : tab.qidx;
    // q, qd, sin q and cos q of the frame's motor, from the lane that
    // holds them (every lane runs the shuffles: qs is the same on all)
    const int src = half + (qs & 15);
    const bool lo = qs < 16;
    const float qv = __shfl_sync(kAll, lo ? qA : qB, src);
    const float qdv = __shfl_sync(kAll, lo ? qdA : qdB, src);
    const float sv = __shfl_sync(kAll, lo ? sinA : sinB, src);
    const float cv = __shfl_sync(kAll, lo ? cosA : cosB, src);
    const float* Tp = p < 0 ? s + L.eye : s + L.T + kRows3 * p;
    const float* Wp = p < 0 ? s + L.zero : s + L.W + kRows3 * p;
    const float* Dp = p < 0 ? s + L.zero : s + L.D + kRows3 * p;
    float* Gf = s + L.G + kRows3 * f;
    float* sA = s + L.sA;
    float* sAE = s + L.sAE;
    float* sAinv = s + L.sAinv;
    const int rr = row3 ? 0 : r;  // this lane's entry of a stored frame
    sA[r] = dot4(row3 ? make_float4(0.0f, 0.0f, 0.0f, 1.0f) : ld4(Tp + 4 * i),
                 tab.tc);
    __syncwarp();
    const float4 arow = ld4(sA + 4 * i);
    const float t = dot4(arow, motion_col(jt, tab.ax, tab.ay, tab.az, qv, sv,
                                          cv, j));  // A Tv
    float w, d;
    if (jt == rmp::kFixed) {
      w = Wp[rr];
      d = Dp[rr];
    } else {
      sAE[r] = dot4(arow, generator_col(jt, tab.ax, tab.ay, tab.az,
                                        j));  // A E
      // entry (i, j) of the rigid inverse of A, without branches
      const float rot = sA[4 * j + i];
      const float trans = -(sA[i] * sA[3] + sA[4 + i] * sA[7] +
                            sA[8 + i] * sA[11]);
      sAinv[r] = i == 3 ? (j == 3 ? 1.0f : 0.0f) : (j < 3 ? rot : trans);
      __syncwarp();
      const float g = dot4(ld4(sAE + 4 * i), col4(sAinv, j));
      if (!row3) Gf[r] = g;
      __syncwarp();
      const float wg = dot4(ld4(Wp + 4 * ir), col3(Gf, j, 0.0f));
      const float gw = dot4(ld4(Gf + 4 * ir), col3(Wp, j, 0.0f));
      w = Wp[rr] + qdv * g;
      d = Dp[rr] + qdv * (wg - gw);
    }
    if (!row3) {
      s[L.T + kRows3 * f + r] = t;
      s[L.W + kRows3 * f + r] = w;
      s[L.D + kRows3 * f + r] = d;
    }
    __syncwarp();  // sA, sAE, sAinv are the next frame's
  }

  // rows r and r + 16 of [A | f]: off the diagonal (row r's columns 0-15,
  // all of its lower triangle), the diagonal, f; the ridge, and the
  // identity on the padded rows
  float rowA[16], rowB[N];
#pragma unroll
  for (int c = 0; c < 16; ++c) rowA[c] = 0.0f;
#pragma unroll
  for (int c = 0; c < N; ++c) rowB[c] = 0.0f;
  float dA = realA ? C[rmp::kRidge] : 1.0f;
  float dB = realB ? C[rmp::kRidge] : 1.0f;
  float fA = 0.0f, fB = 0.0f;
  const float* G = s + L.G;

  // ---- the attractor on the EE position ----
  {
    const float* Te = s + L.T + kRows3 * ee_frame;
    float ph[3], pd[3], cx[3], M[3][3], u[3], JA[3], JB[3];
    origin_terms(ph, pd, cx, Te, s + L.W + kRows3 * ee_frame,
                 s + L.D + kRows3 * ee_frame);
    const int gA = realA ? __ldg(anc + ee_frame * n + r) : -1;
    const int gB = realB ? __ldg(anc + ee_frame * n + r + 16) : -1;
    rmp::attractor_terms(M, u, C, ph, pd, cx,
                         goal + static_cast<size_t>(b) * 3);
    jacobian_column(JA, G, gA, ph);
    jacobian_column(JB, G, gB, ph);
    float* V = s + L.V;
    __syncwarp();  // the recursion's scratch is read
    float vA[3], vB[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      vA[a] = M[a][0] * JA[0] + M[a][1] * JA[1] + M[a][2] * JA[2];
      vB[a] = M[a][0] * JB[0] + M[a][1] * JB[1] + M[a][2] * JB[2];
      V[32 * a + r] = vA[a];
      V[32 * a + r + 16] = vB[a];
    }
    __syncwarp();
    if (gA >= 0) {
      fA += JA[0] * u[0] + JA[1] * u[1] + JA[2] * u[2];
      dA += JA[0] * vA[0] + JA[1] * vA[1] + JA[2] * vA[2];
#pragma unroll
      for (int c = 0; c < 16; c += 4) {
        const float4 a = ld4(V + c), bb = ld4(V + 32 + c),
                     cc = ld4(V + 64 + c);
        rowA[c] += JA[0] * a.x + JA[1] * bb.x + JA[2] * cc.x;
        rowA[c + 1] += JA[0] * a.y + JA[1] * bb.y + JA[2] * cc.y;
        rowA[c + 2] += JA[0] * a.z + JA[1] * bb.z + JA[2] * cc.z;
        rowA[c + 3] += JA[0] * a.w + JA[1] * bb.w + JA[2] * cc.w;
      }
    }
    if (gB >= 0) {
      fB += JB[0] * u[0] + JB[1] * u[1] + JB[2] * u[2];
      dB += JB[0] * vB[0] + JB[1] * vB[1] + JB[2] * vB[2];
#pragma unroll
      for (int c = 0; c < N; c += 4) {
        const float4 a = ld4(V + c), bb = ld4(V + 32 + c),
                     cc = ld4(V + 64 + c);
        rowB[c] += JB[0] * a.x + JB[1] * bb.x + JB[2] * cc.x;
        rowB[c + 1] += JB[0] * a.y + JB[1] * bb.y + JB[2] * cc.y;
        rowB[c + 2] += JB[0] * a.z + JB[1] * bb.z + JB[2] * cc.z;
        rowB[c + 3] += JB[0] * a.w + JB[1] * bb.w + JB[2] * cc.w;
      }
    }
  }

  // ---- the identity-space leaves, in policy order ----
  for (int lp = 0; lp < n_ident; ++lp) {
    const int kind = __ldg(ident + 2 * lp);
    const float* P = C + __ldg(ident + 2 * lp + 1);
    if (kind == rmp::kVelCap) {
      const float cutoff = P[0], region = P[1], clip = P[2], wgt = P[3],
                  gain = P[4];
      float a[2], m[2];
      const float v[2] = {qdA, qdB};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float dv = fabsf(v[h]) - cutoff;
        a[h] = fabsf(v[h]) < cutoff ? 0.0f
                                    : -fabsf(gain * dv) * sign_nan(v[h]);
        const float ratio = min_nan(dv, clip) / region;
        m[h] = wgt / (1.0f - ratio * ratio);
      }
      const float s_all = half_sum((realA ? a[0] : 0.0f)
                                   + (realB ? a[1] : 0.0f));
      if (realA) velcap_row(rowA, dA, fA, r, wgt, a[0], m[0], s_all);
      if (realB) velcap_row(rowB, dB, fB, r + 16, wgt, a[1], m[1], s_all);
    } else if (kind == rmp::kDamping) {
      const float ss = half_sum(qdA * qdA + qdB * qdB);
      const float xdn = sqrtf(max_nan(ss, 1e-20f));
      const float e = P[0] * xdn + P[1];
      if (realA) {
        fA += e * (-P[2] * xdn * qdA);
        dA += e;
      }
      if (realB) {
        fB += e * (-P[2] * xdn * qdB);
        dB += e;
      }
    } else {  // kCspace
      const float thresh = P[0], pg = P[1], dg = P[2], e = P[3];
      const float xsA = realA ? qA - P[4 + r] : 0.0f;
      const float xsB = realB ? qB - P[4 + r + 16] : 0.0f;
      const float xn = sqrtf(max_nan(half_sum(xsA * xsA + xsB * xsB),
                                     1e-24f));
      const float xn_safe = max_nan(xn, 1e-12f);
      if (realA) {
        const float a_pos = xn < thresh ? -xsA * pg
                                        : -thresh * (xsA / xn_safe) * pg;
        fA += e * (a_pos - dg * qdA);
        dA += e;
      }
      if (realB) {
        const float a_pos = xn < thresh ? -xsB * pg
                                        : -thresh * (xsB / xn_safe) * pg;
        fB += e * (a_pos - dg * qdB);
        dB += e;
      }
    }
  }

  // ---- the pairs, 16 staged at a time ----
  {
    const int pairs = n_col * K;
    float* stage = s + L.stage;
    int cur = -1, gA = -1, gB = -1, buf = 0;
    float JA[3] = {0.0f, 0.0f, 0.0f}, JB[3] = {0.0f, 0.0f, 0.0f};
    for (int base = 0; base < pairs; base += 16) {
      __syncwarp();  // the previous batch's terms (and V) are read
      const int pp = base + r;
      if (pp < pairs) {
        const int li = pp / K, k = pp - li * K;
        const int fr = __ldg(col_frames + li);
        const float* Tf = s + L.T + kRows3 * fr;
        float ph[3], pd[3], cx[3], a0[3], a1[3];
        origin_terms(ph, pd, cx, Tf, s + L.W + kRows3 * fr,
                     s + L.D + kRows3 * fr);
        const float* cap = caps + 7 * li;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float* Ta = Tf + 4 * a;
          a0[a] = Ta[0] * cap[0] + Ta[1] * cap[1] + Ta[2] * cap[2] + Ta[3];
          a1[a] = Ta[0] * cap[3] + Ta[1] * cap[4] + Ta[2] * cap[5] + Ta[3];
        }
        const size_t ob = static_cast<size_t>(b) * K + k;
        float nh[3], metric, amc;
        rmp::obstacle_terms(nh, metric, amc, C, pd, cx, a0, a1, cap[6],
                            obs_p0 + 3 * ob, obs_p1 + 3 * ob, obs_r[ob]);
        float* st = stage + kPairStride * r;
        *reinterpret_cast<float4*>(st) = make_float4(nh[0], nh[1], nh[2],
                                                     metric);
        *reinterpret_cast<float4*>(st + 4) = make_float4(amc, ph[0], ph[1],
                                                         ph[2]);
      }
      __syncwarp();
      const int count = min(16, pairs - base);
      for (int jj = 0; jj < count; ++jj) {
        const float* st = stage + kPairStride * jj;
        const float4 t = ld4(st);
        const float4 t2 = ld4(st + 4);  // a - c, the frame origin
        const int li = (base + jj) / K;
        if (li != cur) {  // warp-uniform: a new collision frame
          cur = li;
          const int fr = __ldg(col_frames + li);
          gA = realA ? __ldg(anc + fr * n + r) : -1;
          gB = realB ? __ldg(anc + fr * n + r + 16) : -1;
          const float ph[3] = {t2.y, t2.z, t2.w};
          jacobian_column(JA, G, gA, ph);
          jacobian_column(JB, G, gB, ph);
        }
        const float uA = t.x * JA[0] + t.y * JA[1] + t.z * JA[2];
        const float uB = t.x * JB[0] + t.y * JB[1] + t.z * JB[2];
        float* mu = s + L.mu + 32 * buf;
        const float mA = t.w * uA, mB = t.w * uB;  // metric Jd
        mu[r] = mA;
        mu[r + 16] = mB;
        __syncwarp();
        if (gA >= 0) {
          fA += uA * t.w * t2.x;
          dA += uA * mA;
          add_scaled(rowA, uA, mu);
        }
        if (gB >= 0) {
          fB += uB * t.w * t2.x;
          dB += uB * mB;
          add_scaled(rowB, uB, mu);
        }
        buf ^= 1;
      }
    }
  }

  // ---- Cholesky of the symmetrized A, right-looking, y folded in ----
#pragma unroll
  for (int c = 0; c < 16; ++c)
    if (c < r) rowA[c] = 0.5f * (rowA[c] + rowA[c]);
#pragma unroll
  for (int c = 0; c < N; ++c)
    if (c < r + 16) rowB[c] = 0.5f * (rowB[c] + rowB[c]);
  float LA = 1.0f, LB = 1.0f;  // L's diagonal on rows r, r + 16
  __syncwarp();  // the pairs' buffers are read
#pragma unroll
  for (int jc = 0; jc < N; ++jc) {
    const bool hi = jc >= 16;
    const int src = half + (jc & 15);
    const float dj = __shfl_sync(kAll, hi ? dB : dA, src);
    const float fj = __shfl_sync(kAll, hi ? fB : fA, src);
    const float Ljj = sqrtf(max_nan(dj, 1e-12f));
    const float inv = 1.0f / Ljj;
    const float yj = fj / Ljj;
    const bool belowA = !hi && r > jc, belowB = r + 16 > jc;
    // the lane's entries of column j of L, staged for the trailing rows
    const float lA = hi ? 0.0f : rowA[hi ? 0 : jc] * inv;
    const float lB = rowB[jc] * inv;
    float* cb = s + L.col + 32 * (jc & 1);
    cb[r] = lA;
    cb[r + 16] = lB;
    if (!hi) {
      rowA[hi ? 0 : jc] = lA;
      if (r == jc) {
        LA = Ljj;
        fA = yj;
      } else if (belowA) {
        fA -= lA * yj;
        dA -= lA * lA;
      }
    }
    rowB[jc] = lB;
    if (r + 16 == jc) {
      LB = Ljj;
      fB = yj;
    } else if (belowB) {
      fB -= lB * yj;
      dB -= lB * lB;
    }
    __syncwarp();
    // the trailing entries: a_rk -= l_rj l_kj, l_kj read as float4s
#pragma unroll
    for (int k4 = (jc + 1) & ~3; k4 < N; k4 += 4) {
      const float4 v = ld4(cb + k4);
      const float lk[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = k4 + u;
        if (k <= jc) continue;
        if (k < 16) rowA[k < 16 ? k : 0] -= lA * lk[u];
        rowB[k] -= lB * lk[u];
      }
    }
  }

  // ---- L^T x = y, a column sweep over L's rows in shared memory ----
  float* Lr = s + L.Lrow;
  __syncwarp();  // the column buffers are read
#pragma unroll
  for (int c = 0; c < 16; c += 4)
    *reinterpret_cast<float4*>(Lr + L.pitch * r + c) =
        make_float4(rowA[c], rowA[c + 1], rowA[c + 2], rowA[c + 3]);
  if (r + 16 < N) {
#pragma unroll
    for (int c = 0; c < N; c += 4)
      *reinterpret_cast<float4*>(Lr + L.pitch * (r + 16) + c) =
          make_float4(rowB[c], rowB[c + 1], rowB[c + 2], rowB[c + 3]);
  }
  __syncwarp();
  float xA = 0.0f, xB = 0.0f;
#pragma unroll
  for (int ic = N - 1; ic >= 0; --ic) {
    const bool hi = ic >= 16;
    const int src = half + (ic & 15);
    const float x = __shfl_sync(kAll, hi ? fB / LB : fA / LA, src);
    if (hi) {
      if (r + 16 == ic) xB = x;
    } else if (r == ic) {
      xA = x;
    }
    if (r < ic) fA -= Lr[L.pitch * ic + r] * x;
    if (r + 16 < ic) fB -= Lr[L.pitch * ic + r + 16] * x;
  }
  if (live) {
    if (realA) out[o + r] = xA;
    if (realB) out[o + r + 16] = xB;
  }
}

// Declared here, defined in fused_tick_wide.cu (the instantiations and
// their launch): the launch on `stream` (cudaGetLastError() after it), the
// dynamic shared memory a CTA, and the envs an SM holds at once at that
// size (-1 on an error).
int launch_wide(int B, int F, int n, int K, int n_col, int ee_frame,
                int n_ident, const int* parent, const int* joint_type,
                const int* q_index, const float* axis,
                const float* T_constant, const int* anc,
                const int* col_frames, const float* caps, const int* ident,
                const float* consts, const float* q, const float* qd,
                const float* goal, const float* obs_p0, const float* obs_p1,
                const float* obs_r, float* out, cudaStream_t stream);
int wide_shared_bytes(int F, int n);
int wide_envs_per_sm(int F, int n);

}  // namespace rmp_k5
