// Device code shared by K3 (fk_derivatives.cu) and K5 (fused_tick.cu): the
// 4x4 helpers and one step of the world twist-generator FK recursion.
//
// For frame f with parent p and parent-side rigid transform
// A_f = T_p T_constant_f:
//   T_f  = A_f Tv_f(q)                    (Tv the joint motion)
//   G_f  = A_f E_f A_f^{-1}               (world twist generator, actuated)
//   W_f  = W_p + qd G_f                   (velocity operator, Td = W T)
//   Wd_f = Wd_p + qd (W_p G_f - G_f W_p)  (its drift)
// A fixed frame inherits W and Wd and has no generator.
#pragma once

#include <cuda_runtime.h>

namespace rmp {

constexpr int kMaxFrames = 16;
constexpr int kMaxMotors = 16;
constexpr int kRevolute = 0;
constexpr int kPrismatic = 1;
constexpr int kFixed = 2;

// c = a @ b for row-major 4x4 matrices; c must not alias a or b.
__device__ __forceinline__ void mm44(const float* a, const float* b, float* c) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = a[4 * i] * b[j];
#pragma unroll
      for (int k = 1; k < 4; ++k) s += a[4 * i + k] * b[4 * k + j];
      c[4 * i + j] = s;
    }
  }
}

__device__ __forceinline__ void set_identity(float* m) {
#pragma unroll
  for (int r = 0; r < 16; ++r) m[r] = (r % 5 == 0) ? 1.0f : 0.0f;
}

// Inverse of a rigid transform: [R t; 0 1]^-1 = [R^T, -R^T t; 0 1].
__device__ __forceinline__ void rigid_inverse(const float* a, float* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) out[4 * i + j] = a[4 * j + i];
    out[4 * i + 3] = -(a[i] * a[3] + a[4 + i] * a[7] + a[8 + i] * a[11]);
  }
  out[12] = 0.0f;
  out[13] = 0.0f;
  out[14] = 0.0f;
  out[15] = 1.0f;
}

// One step of the recursion: T[f], W[f], Wd[f] and, for an actuated joint,
// G[f], from the parent's entries (already computed: frames come in BFS
// order). q_row and qd_row are this environment's (n,) rows.
__device__ __forceinline__ void fk_step(
    int f, const int* __restrict__ parent, const int* __restrict__ joint_type,
    const int* __restrict__ q_index, const float* __restrict__ axis,
    const float* __restrict__ T_constant, const float* q_row,
    const float* qd_row, float (*T)[16], float (*W)[16], float (*Wd)[16],
    float (*G)[16]) {
  float eye[16];
  float zero[16];
  set_identity(eye);
#pragma unroll
  for (int r = 0; r < 16; ++r) zero[r] = 0.0f;

  const int p = parent[f];
  const float* Tp = p < 0 ? eye : T[p];
  const float* Wp = p < 0 ? zero : W[p];
  const float* Wdp = p < 0 ? zero : Wd[p];
  const int jt = joint_type[f];
  const float ax = axis[3 * f], ay = axis[3 * f + 1], az = axis[3 * f + 2];

  float A[16];
  mm44(Tp, T_constant + 16 * f, A);

  // joint motion: Rodrigues (guarded to identity for a zero axis, as the
  // plain version's rotation_matrix_from_axis_angle) or a translation
  float Tv[16];
  set_identity(Tv);
  if (jt == kRevolute) {
    float s, c;
    sincosf(q_row[q_index[f]], &s, &c);
    if (ax * ax + ay * ay + az * az > 0.5f) {
      const float oc = 1.0f - c;
      Tv[0] = c + oc * (ax * ax);
      Tv[1] = -s * az + oc * (ax * ay);
      Tv[2] = s * ay + oc * (ax * az);
      Tv[4] = s * az + oc * (ay * ax);
      Tv[5] = c + oc * (ay * ay);
      Tv[6] = -s * ax + oc * (ay * az);
      Tv[8] = -s * ay + oc * (az * ax);
      Tv[9] = s * ax + oc * (az * ay);
      Tv[10] = c + oc * (az * az);
    }
  } else if (jt == kPrismatic) {
    const float qv = q_row[q_index[f]];
    Tv[3] = qv * ax;
    Tv[7] = qv * ay;
    Tv[11] = qv * az;
  }
  mm44(A, Tv, T[f]);

  if (jt == kFixed) {
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      W[f][r] = Wp[r];
      Wd[f][r] = Wdp[r];
    }
    return;
  }
  float E[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) E[r] = 0.0f;
  if (jt == kRevolute) {
    E[1] = -az; E[2] = ay;
    E[4] = az;  E[6] = -ax;
    E[8] = -ay; E[9] = ax;
  } else {
    E[3] = ax; E[7] = ay; E[11] = az;
  }
  float AE[16], Ainv[16];
  mm44(A, E, AE);
  rigid_inverse(A, Ainv);
  mm44(AE, Ainv, G[f]);
  const float qdv = qd_row[q_index[f]];
  float WG[16], GW[16];
  mm44(Wp, G[f], WG);
  mm44(G[f], Wp, GW);
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    W[f][r] = Wp[r] + qdv * G[f][r];
    Wd[f][r] = Wdp[r] + qdv * (WG[r] - GW[r]);
  }
}

}  // namespace rmp
