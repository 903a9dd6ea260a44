// K5: the whole v2 tick in one kernel, one thread per environment.
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
//
// The arithmetic follows the JAX body step by step, with its order of
// accumulation: structural zeros are skipped, not multiplied (a Jacobian
// column of a motor that is no ancestor of the frame, read from `anc`), so a
// 0 * inf of the velocity cap's singularity never becomes a NaN where the
// reference gives a number; max/min/clip propagate NaN as jnp's do; the
// policy constants arrive folded in float64 and rounded once (consts).
// nvcc contracts a * b + c into FMAs, which the JAX body does not: results
// part from the plain version by rounding (chip_smoke.py holds them to
// 2e-4 x max(1, |qdd|)), and the logistic is 1 / (1 + expf(-x)).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32): operations. Per env it
// reads 21 + 7K floats and writes n = 9 (316 B at K = 7) but does 23,269
// operations at the flagship (10 collision frames x 7 obstacles): the
// reference body's, constants folded, less A's mirrored upper triangle
// (ops/tick_ops.fused_qdd_ops). This kernel folds no constant of the model
// and does more. Design: one thread per env, as K1 and K3; the FK
// arrays are indexed by a run-time frame number and live in local memory
// (4 KB per thread, L1-cached); A (n x n), f and the per-pair rows are
// indexed at compile time (n = 9 is a template parameter) so they can stay
// in registers, at the price of register pressure (ptxas: 242 registers,
// no spills; PERF.md). At B = 4096 only 32 blocks have work, and each
// thread's chain of dependent operations sets the time: far above the
// bound, which this first version accepts.
#include <cuda_runtime.h>

#include "fk_common.cuh"

namespace {

using rmp::kMaxFrames;
using rmp::mm44;

constexpr int kThreads = 128;
constexpr int kMaxCollision = 16;
constexpr int kMaxIdentity = 8;
constexpr float kSegEps = 1e-9f;   // sim/collision._EPS

// offsets into consts, mirrored in ops/cuda_tick.py
enum : int {
  kRidge = 0,
  kAttP, kAttD, kAttEps, kAttSoft, kAttAlphaLs, kAttOneMinusMinAlpha,
  kAttMinAlpha, kAttBoostLs, kAttBoost, kAttMaxS, kAttMinS,
  kObsMargin, kObsRmod, kObsRmodSq, kObsMetric, kObsExploderStd,
  kObsExploderEps, kObsRepGain, kObsRepStd, kObsGateLs, kObsDampGain,
  kObsDampStd, kObsRobustEps,
};
enum : int { kVelCap = 1, kDamping = 2, kCspace = 3 };

// jnp.maximum / jnp.minimum / jnp.clip(x, 0, 1): NaN in x stays NaN
__device__ __forceinline__ float max_nan(float x, float c) {
  return x != x ? x : fmaxf(x, c);
}
__device__ __forceinline__ float min_nan(float x, float c) {
  return x != x ? x : fminf(x, c);
}
__device__ __forceinline__ float clip01(float x) {
  return x != x ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}
// jnp.sign: -1, 0 or 1; NaN stays NaN
__device__ __forceinline__ float sign_nan(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// (p, pd, J on the ancestor columns, c) of the origin of frame f; act[m]
// marks the motors that drive it (anc >= 0), J is 0 elsewhere.
template <int N>
__device__ __forceinline__ void point_derivs(
    int f, const float (*T)[16], const float (*W)[16], const float (*Wd)[16],
    const float (*G)[16], const int* __restrict__ anc, float p[3],
    float pd[3], float J[3][N], float c[3], bool act[N]) {
  const float ph[4] = {T[f][3], T[f][7], T[f][11], 1.0f};
  float acc[16];
  mm44(W[f], W[f], acc);
#pragma unroll
  for (int r = 0; r < 16; ++r) acc[r] = Wd[f][r] + acc[r];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[i] = ph[i];
    pd[i] = W[f][4 * i] * ph[0] + W[f][4 * i + 1] * ph[1]
            + W[f][4 * i + 2] * ph[2] + W[f][4 * i + 3];
    c[i] = acc[4 * i] * ph[0] + acc[4 * i + 1] * ph[1]
           + acc[4 * i + 2] * ph[2] + acc[4 * i + 3];
  }
#pragma unroll
  for (int m = 0; m < N; ++m) {
    const int j = anc[f * N + m];
    act[m] = j >= 0;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      J[i][m] = j >= 0 ? G[j][4 * i] * ph[0] + G[j][4 * i + 1] * ph[1]
                             + G[j][4 * i + 2] * ph[2] + G[j][4 * i + 3]
                       : 0.0f;
  }
}

__device__ __forceinline__ void transform_point(const float* T,
                                                const float* p, float* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = T[4 * i] * p[0] + T[4 * i + 1] * p[1] + T[4 * i + 2] * p[2]
             + T[4 * i + 3];
}

template <int N>
__global__ void __launch_bounds__(kThreads) fused_qdd_kernel(
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
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* qb = q + (size_t)b * N;
  const float* qdb = qd + (size_t)b * N;

  float T[kMaxFrames][16];
  float W[kMaxFrames][16];
  float Wd[kMaxFrames][16];
  float G[kMaxFrames][16];
  for (int f = 0; f < F; ++f)
    rmp::fk_step(f, parent, joint_type, q_index, axis, T_constant, qb, qdb,
                 T, W, Wd, G);

  float A[N][N];
  float fs[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    fs[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < N; ++j) A[i][j] = i == j ? C[kRidge] : 0.0f;
  }

  float J[3][N];
  bool act[N];

  // ---- attractor on the EE position ------------------------------------
  {
    float x[3], xd[3], cx[3];
    point_derivs<N>(ee_frame, T, W, Wd, G, anc, x, xd, J, cx, act);
    float delta[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) delta[i] = goal[(size_t)b * 3 + i] - x[i];
    const float dn = sqrtf(max_nan(dot3(delta, delta), 1e-20f));
    const float soft = max_nan(dn, C[kAttSoft]);
    float dhat[3], amc[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      dhat[i] = delta[i] / soft;
      amc[i] = (C[kAttP] * delta[i] / (dn + C[kAttEps]) - C[kAttD] * xd[i])
               - cx[i];
    }
    const float scaled = dn / C[kAttAlphaLs];
    const float alpha = C[kAttOneMinusMinAlpha] * expf(-0.5f * scaled * scaled)
                        + C[kAttMinAlpha];
    const float bs = dn / C[kAttBoostLs];
    const float boost_a = expf(-0.5f * bs * bs);
    const float boost = boost_a * C[kAttBoost] + (1.0f - boost_a);
    float M[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        M[i][j] = boost * ((i == j ? alpha * C[kAttMaxS] : 0.0f)
                           + (1.0f - alpha) * C[kAttMinS] * dhat[i] * dhat[j]);
    float u[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      u[i] = M[i][0] * amc[0] + M[i][1] * amc[1] + M[i][2] * amc[2];
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
        const float contrib = J[0][ic] * Wa[0][jc] + J[1][ic] * Wa[1][jc]
                              + J[2][ic] * Wa[2][jc];
        A[ic][jc] += contrib;
        if (ic != jc) A[jc][ic] += contrib;
      }
    }
  }

  // ---- identity-space leaves, in policy order ----------------------------
  for (int p = 0; p < n_ident; ++p) {
    const int kind = ident[2 * p];
    const float* P = C + ident[2 * p + 1];
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
        for (int j = 0; j < N; ++j) A[i][j] += wgt;
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

  // ---- grouped obstacle avoidance: first capsule of each frame ----------
  for (int li = 0; li < n_col; ++li) {
    const int fr = col_frames[li];
    float porg[3], pd[3], co[3];
    point_derivs<N>(fr, T, W, Wd, G, anc, porg, pd, J, co, act);
    float a0[3], a1[3];
    transform_point(T[fr], caps + 7 * li, a0);
    transform_point(T[fr], caps + 7 * li + 3, a1);
    const float rad = caps[7 * li + 6];
    float d1[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) d1[i] = a1[i] - a0[i];
    const float pd_sq = dot3(pd, pd);

    for (int k = 0; k < K; ++k) {
      const float* b0 = obs_p0 + ((size_t)b * K + k) * 3;
      const float* b1 = obs_p1 + ((size_t)b * K + k) * 3;
      float d2[3], r[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        d2[i] = b1[i] - b0[i];
        r[i] = a0[i] - b0[i];
      }
      // clamped closest-point parameters (pallas_tick._seg_closest)
      const float sa = dot3(d1, d1), se = dot3(d2, d2), sf = dot3(d2, r),
                  sc = dot3(d1, r), sb = dot3(d1, d2);
      const float denom = sa * se - sb * sb;
      float s = denom > kSegEps ? (sb * sf - sc * se) / (denom + kSegEps)
                                : 0.0f;
      s = se > kSegEps ? s : -sc / (sa + kSegEps);
      s = clip01(s);
      const float t = se > kSegEps ? (sb * s + sf) / (se + kSegEps) : 0.0f;
      const float t_cl = clip01(t);
      if (t != t_cl && sa > kSegEps) s = clip01((t_cl * sb - sc) / (sa + kSegEps));

      float ca[3], cb[3], diff[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        ca[i] = a0[i] + s * d1[i];
        cb[i] = b0[i] + t_cl * d2[i];
        diff[i] = ca[i] - cb[i];
      }
      const float cdist = sqrtf(max_nan(dot3(diff, diff), 1e-18f));
      const float rk = obs_r[(size_t)b * K + k];
      float h[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float nv = diff[i] / cdist;
        h[i] = (ca[i] - rad * nv) - (cb[i] + rk * nv);
      }
      const float d_c = sqrtf(max_nan(dot3(h, h), 1e-18f));
      float nh[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) nh[i] = h[i] / d_c;

      float Jd[N];
#pragma unroll
      for (int j = 0; j < N; ++j)
        Jd[j] = nh[0] * J[0][j] + nh[1] * J[1][j] + nh[2] * J[2][j];
      const float xd_d = dot3(nh, pd);
      const float c_d = dot3(nh, co) + (pd_sq - xd_d * xd_d) / d_c;

      // policy (v2 ObstacleAvoidance)
      const float xdist = max_nan(d_c - C[kObsMargin], 0.0f);
      const bool far = xdist > C[kObsRmod];
      const float gate = far ? 0.0f
                             : xdist * xdist / C[kObsRmodSq]
                                   - 2.0f * xdist / C[kObsRmod] + 1.0f;
      const float base = C[kObsMetric]
                         / (xdist / C[kObsExploderStd] + C[kObsExploderEps]);
      const float a_rep = C[kObsRepGain] * expf(-xdist / C[kObsRepStd]);
      const float sig = 1.0f / (1.0f + expf(-(xd_d / C[kObsGateLs])));
      const float a_damp = -(1.0f - sig) * C[kObsDampGain] * xd_d
                           / (xdist / C[kObsDampStd] + C[kObsRobustEps]);
      const float metric = far ? 0.0f : (1.0f - sig) * (base * gate);
      const float amc = a_rep + a_damp - c_d;

#pragma unroll
      for (int jc = 0; jc < N; ++jc) {
        if (!act[jc]) continue;
        fs[jc] += Jd[jc] * metric * amc;
        const float mj = metric * Jd[jc];
#pragma unroll
        for (int ic = jc; ic < N; ++ic) {
          if (!act[ic]) continue;
          const float contrib = Jd[ic] * mj;
          A[ic][jc] += contrib;
          if (ic != jc) A[jc][ic] += contrib;
        }
      }
    }
  }

  // ---- unrolled Cholesky of the symmetrized A, in place (lower) ---------
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < i; ++j) A[i][j] = 0.5f * (A[i][j] + A[j][i]);
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
#pragma unroll
  for (int i = 0; i < N; ++i) out[(size_t)b * N + i] = xs[i];
}

}  // namespace

// Launches on `stream` of GPU `device`. Returns cudaGetLastError() after the
// launch, or -1 when the model or env exceeds the kernel's capacity (n = 9
// motors only, up to kMaxFrames frames, kMaxCollision collision frames and
// kMaxIdentity identity-space leaves; nothing is launched then).
extern "C" int rmp_fused_qdd_f32(
    int device, int B, int F, int n, int K, int n_col, int ee_frame,
    int n_ident, const int* parent, const int* joint_type,
    const int* q_index, const float* axis, const float* T_constant,
    const int* anc, const int* col_frames, const float* caps,
    const int* ident, const float* consts, const float* q, const float* qd,
    const float* goal, const float* obs_p0, const float* obs_p1,
    const float* obs_r, float* out, void* stream) {
  if (n != 9 || F > kMaxFrames || n_col > kMaxCollision ||
      n_ident > kMaxIdentity)
    return -1;
  if (B <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = (B + kThreads - 1) / kThreads;
  fused_qdd_kernel<9><<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      B, F, K, n_col, ee_frame, n_ident, parent, joint_type, q_index, axis,
      T_constant, anc, col_frames, caps, ident, consts, q, qd, goal, obs_p0,
      obs_p1, obs_r, out);
  return static_cast<int>(cudaGetLastError());
}
