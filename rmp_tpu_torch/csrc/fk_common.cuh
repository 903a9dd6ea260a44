// Device code shared by K3 (fk_derivatives.cu) and K5 (fused_tick.cu): the
// world twist-generator FK recursion of one environment, run by 16 lanes on
// shared memory, and the per-frame pieces of its prologue.
//
// For frame f with parent p and parent-side rigid transform
// A_f = T_p T_constant_f:
//   T_f  = A_f Tv_f(q)                    (Tv the joint motion)
//   G_f  = A_f E_f A_f^{-1}               (world twist generator, actuated)
//   W_f  = W_p + qd G_f                   (velocity operator, Td = W T)
//   Wd_f = Wd_p + qd (W_p G_f - G_f W_p)  (its drift)
// A fixed frame inherits W and Wd and has no generator. Every entry of a 4x4
// product sums a[4i] b[j] first, then k = 1..3 (dot4).
#pragma once

#include <cuda_runtime.h>

namespace rmp {

constexpr int kRevolute = 0;
constexpr int kPrismatic = 1;
constexpr int kFixed = 2;
// Floats between an env's generators G_f and G_f+1. K3's store pass reads
// row i of up to 8 generators in one quarter warp: at a pitch of 16 floats
// those rows fall into 2 of the 8 16-byte bank groups, at 20 into 8.
constexpr int kGPitch = 20;

// Smallest stride >= s that is 16 mod 32 floats: the two envs of a warp
// then read the same entry from opposite halves of the 32 banks.
__host__ __device__ constexpr int odd_half(int s) {
  return s + (48 - s % 32) % 32;
}

// a . b in the recursion's order (a.x b.x first): entry (i, j) of a 4x4
// product from row i of the left factor and column j of the right one.
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  float s = a.x * b.x;
  s += a.y * b.y;
  s += a.z * b.z;
  s += a.w * b.w;
  return s;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Column j of a row-major 4x4 matrix in shared memory.
__device__ __forceinline__ float4 col4(const float* m, int j) {
  return make_float4(m[j], m[4 + j], m[8 + j], m[12 + j]);
}

// The joint motion Tv of a frame of joint type jt: Rodrigues (identity for a
// zero axis, as the plain version's rotation_matrix_from_axis_angle), a
// translation, or the identity.
__device__ __forceinline__ void joint_motion(float (&tv)[16], int jt,
                                             float ax, float ay, float az,
                                             float qv) {
#pragma unroll
  for (int k = 0; k < 16; ++k) tv[k] = (k % 5 == 0) ? 1.0f : 0.0f;
  if (jt == kRevolute) {
    float s, c;
    sincosf(qv, &s, &c);
    if (ax * ax + ay * ay + az * az > 0.5f) {
      const float oc = 1.0f - c;
      tv[0] = c + oc * (ax * ax);
      tv[1] = -s * az + oc * (ax * ay);
      tv[2] = s * ay + oc * (ax * az);
      tv[4] = s * az + oc * (ay * ax);
      tv[5] = c + oc * (ay * ay);
      tv[6] = -s * ax + oc * (ay * az);
      tv[8] = -s * ay + oc * (az * ax);
      tv[9] = s * ax + oc * (az * ay);
      tv[10] = c + oc * (az * az);
    }
  } else if (jt == kPrismatic) {
    tv[3] = qv * ax;
    tv[7] = qv * ay;
    tv[11] = qv * az;
  }
}

// The generator E of a joint (skew(axis), or the axis as a translation).
__device__ __forceinline__ void joint_generator(float (&E)[16], int jt,
                                                float ax, float ay,
                                                float az) {
#pragma unroll
  for (int k = 0; k < 16; ++k) E[k] = 0.0f;
  if (jt == kRevolute) {
    E[1] = -az; E[2] = ay;
    E[4] = az;  E[6] = -ax;
    E[8] = -ay; E[9] = ax;
  } else if (jt == kPrismatic) {
    E[3] = ax; E[7] = ay; E[11] = az;
  }
}

// m transposed into dst (16 floats).
__device__ __forceinline__ void store_transposed(float* dst,
                                                 const float (&m)[16]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) dst[4 * (k % 4) + k / 4] = m[k];
}

// The model's tables in shared memory: parent, joint type and motor index
// per frame, the constant transforms Tc (F x 16), the joint generators'
// transposes Et (F x 16, from joint_generator) and `eye`, the identity
// followed by the zero matrix.
struct FkModel {
  const int* parent;
  const int* type;
  const int* qidx;
  const float* Tc;
  const float* Et;
  const float* eye;
};

// One environment's arrays in shared memory, 16 floats per frame (G at
// kGPitch). C holds Wd during the recursion and Wd + W W after it. Tt, if
// not null, receives T transposed. TvT holds the joint motions' transposes
// (joint_motion), scratch 48 floats of the current frame's A, A E, A^{-1}.
struct FkArrays {
  float* T;
  float* Tt;
  float* W;
  float* C;
  float* G;
  float* scratch;
  const float* TvT;
  const float* qd;  // the environment's joint velocities
};

// The recursion over frames 0..F-1 (BFS order) on the 16 lanes of one
// environment, lane r owning entry (r / 4, r % 4) of every 4x4 product.
// The 16 lanes sit in one half warp: __syncwarp orders them, so every lane
// of the warp must call this.
__device__ __forceinline__ void fk_recursion(int F, int r, const FkModel& m,
                                             const FkArrays& a) {
  const int i = r >> 2, j = r & 3;
  float* sA = a.scratch;
  float* sAE = sA + 16;
  float* sAinv = sA + 32;
  const float* zero = m.eye + 16;
  for (int f = 0; f < F; ++f) {
    // p and jt are the same for every env: branches on them are uniform
    const int p = m.parent[f];
    const float* Tp = p < 0 ? m.eye : a.T + 16 * p;
    const float* Wp = p < 0 ? zero : a.W + 16 * p;
    const float* Wdp = p < 0 ? zero : a.C + 16 * p;
    const int jt = m.type[f];

    sA[r] = dot4(ld4(Tp + 4 * i), col4(m.Tc + 16 * f, j));
    __syncwarp();
    const float4 arow = ld4(sA + 4 * i);
    const float t = dot4(arow, ld4(a.TvT + 16 * f + 4 * j));  // A Tv
    a.T[16 * f + r] = t;
    if (a.Tt != nullptr) a.Tt[16 * f + 4 * j + i] = t;

    if (jt == kFixed) {
      a.W[16 * f + r] = Wp[r];
      a.C[16 * f + r] = Wdp[r];
    } else {
      sAE[r] = dot4(arow, ld4(m.Et + 16 * f + 4 * j));  // A E
      // entry (i, j) of the rigid inverse of A, without branches
      const float rot = sA[4 * j + i];
      const float trans = -(sA[i] * sA[3] + sA[4 + i] * sA[7] +
                            sA[8 + i] * sA[11]);
      sAinv[r] = i == 3 ? (j == 3 ? 1.0f : 0.0f) : (j < 3 ? rot : trans);
      __syncwarp();
      const float g = dot4(ld4(sAE + 4 * i), col4(sAinv, j));
      float* Gf = a.G + kGPitch * f;
      Gf[r] = g;
      __syncwarp();
      const float wg = dot4(ld4(Wp + 4 * i), col4(Gf, j));
      const float gw = dot4(ld4(Gf + 4 * i), col4(Wp, j));
      const float qdv = a.qd[m.qidx[f]];
      a.W[16 * f + r] = Wp[r] + qdv * g;
      a.C[16 * f + r] = Wdp[r] + qdv * (wg - gw);
    }
    __syncwarp();
  }
  // C's left factor, in place: each lane reads W and its own C entry
  for (int f = 0; f < F; ++f) {
    const float ww = dot4(ld4(a.W + 16 * f + 4 * i), col4(a.W + 16 * f, j));
    a.C[16 * f + r] = ww + a.C[16 * f + r];
  }
  __syncwarp();
}

}  // namespace rmp
