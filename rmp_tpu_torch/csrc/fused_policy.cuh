// Device code shared by K5's two kernels (fused_tick.cu: 16 lanes an env,
// n <= 16; fused_tick_wide.cu: a warp an env, n <= 32): the layout of the
// folded policy constants, the NaN rules of jnp's max/min/clip/sign, and
// the scalar parts of the attractor and of one obstacle pair, each in the
// arithmetic order of the JAX body (rmp_tpu/ops/pallas_tick.py).
#pragma once

#include <cuda_runtime.h>

namespace rmp {

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
// identity-space leaf codes (ops/cuda_tick.py VELCAP, DAMPING, CSPACE)
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

// The attractor's task-space metric M and force u = M (a - c) at the EE
// position x, velocity xd and curvature cx.
__device__ __forceinline__ void attractor_terms(
    float (&M)[3][3], float (&u)[3], const float* __restrict__ C,
    const float* x, const float* xd, const float* cx, const float* goal) {
  float delta[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) delta[i] = goal[i] - x[i];
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
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      M[i][j] = boost * ((i == j ? alpha * C[kAttMaxS] : 0.0f)
                         + (1.0f - alpha) * C[kAttMinS] * dhat[i] * dhat[j]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    u[i] = M[i][0] * amc[0] + M[i][1] * amc[1] + M[i][2] * amc[2];
}

// The obstacle policy on one (collision frame, obstacle) pair: the frame
// origin's velocity pd and curvature co, its first capsule's world ends
// a0, a1 and radius rad, the obstacle's segment b0, b1 and radius rk. Out:
// the distance row's direction nh (dd/dq = nh^T J_origin), the policy's
// scalar metric and a - c_d.
__device__ __forceinline__ void obstacle_terms(
    float (&nh)[3], float& metric, float& amc_out,
    const float* __restrict__ C, const float* pd, const float* co,
    const float* a0, const float* a1, float rad, const float* b0,
    const float* b1, float rk) {
  float d1[3], d2[3], r[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    d1[i] = a1[i] - a0[i];
    d2[i] = b1[i] - b0[i];
    r[i] = a0[i] - b0[i];
  }
  const float pd_sq = dot3(pd, pd);
  // clamped closest-point parameters (pallas_tick._seg_closest)
  const float sa = dot3(d1, d1), se = dot3(d2, d2), sf = dot3(d2, r),
              sc = dot3(d1, r), sb = dot3(d1, d2);
  const float denom = sa * se - sb * sb;
  float s = denom > kSegEps ? (sb * sf - sc * se) / (denom + kSegEps) : 0.0f;
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
  float h[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float nv = diff[i] / cdist;
    h[i] = (ca[i] - rad * nv) - (cb[i] + rk * nv);
  }
  const float d_c = sqrtf(max_nan(dot3(h, h), 1e-18f));
#pragma unroll
  for (int i = 0; i < 3; ++i) nh[i] = h[i] / d_c;

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
  metric = far ? 0.0f : (1.0f - sig) * (base * gate);
  amc_out = a_rep + a_damp - c_d;
}

}  // namespace rmp
