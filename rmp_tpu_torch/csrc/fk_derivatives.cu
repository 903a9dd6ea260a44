// K3: batched closed-form FK derivatives, one thread per environment.
//
// Replaces the TPU kernel rmp_tpu/ops/pallas_fk.py::fk_derivatives_batched
// (_build / _make_kernel). For every frame f of a kinematic tree it computes
//   T_f            world transform
//   Td_f = W_f T_f                       (velocity, W = sum of qd_j G_j)
//   c_f  = (Wd_f + W_f W_f) T_f          (curvature at qdd = 0)
//   J_f[:, m] = G_j T_f                  (Jacobian column of motor m whose
//                                          joint j is an ancestor of f)
// with the world twist generators G_j = A_j E_j A_j^{-1}, A_j the parent-side
// rigid transform of joint j. Plain version: models/fk_derivatives.py.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32): bytes. At B = 4096 and
// the Panda (F = 12, n = 9) the outputs are 2,304 floats per env (T, Td, c:
// 3 x 12 x 16; J: 12 x 16 x 9), about 37.7 MB, so ~11 us; the arithmetic is
// ~20 kFLOP per env, ~1.3 us at the fp32 peak.
//
// Design: the model's static tables (parent, joint type, motor index, axis,
// constant transforms, and the ancestor table anc[f][m]) come in as small
// device arrays, so one compiled kernel serves every robot up to kMaxFrames
// frames and kMaxMotors motors. Each thread walks the tree in BFS order and
// keeps T, W, Wd and G of every frame in per-thread arrays; indexed by a
// run-time frame number they live in local memory (L1-cached), which this
// first version accepts. Each frame's outputs are written as soon as the
// frame is done. The writes are batch-major (the contract of the TPU kernel's
// wrapper), so neighbouring threads write 9 KB apart: the stores are not
// coalesced and the kernel is expected to sit well above its bound. Making it
// coalesced (staging rows through shared memory) is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxFrames = 16;
constexpr int kMaxMotors = 16;
constexpr int kRevolute = 0;
constexpr int kPrismatic = 1;
constexpr int kFixed = 2;
constexpr int kThreads = 128;

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

__device__ __forceinline__ void store16(float* dst, const float* src) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int r = 0; r < 4; ++r)
    d[r] = make_float4(src[4 * r], src[4 * r + 1], src[4 * r + 2],
                       src[4 * r + 3]);
}

__global__ void __launch_bounds__(kThreads) fk_derivatives_kernel(
    int B, int F, int n, const int* __restrict__ parent,
    const int* __restrict__ joint_type, const int* __restrict__ q_index,
    const float* __restrict__ axis, const float* __restrict__ T_constant,
    const int* __restrict__ anc, const float* __restrict__ q,
    const float* __restrict__ qd, float* __restrict__ T16,
    float* __restrict__ Td16, float* __restrict__ J16,
    float* __restrict__ c16) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  float T[kMaxFrames][16];
  float W[kMaxFrames][16];
  float Wd[kMaxFrames][16];
  float G[kMaxFrames][16];
  float eye[16];
  float zero[16];
  set_identity(eye);
#pragma unroll
  for (int r = 0; r < 16; ++r) zero[r] = 0.0f;

  for (int f = 0; f < F; ++f) {
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
      sincosf(q[(size_t)b * n + q_index[f]], &s, &c);
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
      const float qv = q[(size_t)b * n + q_index[f]];
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
    } else {
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
      const float qdv = qd[(size_t)b * n + q_index[f]];
      float WG[16], GW[16];
      mm44(Wp, G[f], WG);
      mm44(G[f], Wp, GW);
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        W[f][r] = Wp[r] + qdv * G[f][r];
        Wd[f][r] = Wdp[r] + qdv * (WG[r] - GW[r]);
      }
    }

    const size_t row = (size_t)b * F + f;
    float out[16];
    store16(T16 + row * 16, T[f]);
    mm44(W[f], T[f], out);
    store16(Td16 + row * 16, out);
    float acc[16];
    mm44(W[f], W[f], acc);
#pragma unroll
    for (int r = 0; r < 16; ++r) acc[r] += Wd[f][r];
    mm44(acc, T[f], out);
    store16(c16 + row * 16, out);

    float* jrow = J16 + row * 16 * n;
    for (int m = 0; m < n; ++m) {
      const int j = anc[f * n + m];
      if (j >= 0) {
        mm44(G[j], T[f], out);
      } else {
#pragma unroll
        for (int r = 0; r < 16; ++r) out[r] = 0.0f;
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) jrow[r * n + m] = out[r];
    }
  }
}

}  // namespace

// Launches on `stream` of GPU `device`. Returns cudaGetLastError() after the
// launch, or -1 when the model exceeds the kernel's frame/motor capacity
// (nothing is launched then).
extern "C" int rmp_fk_derivatives_f32(
    int device, int B, int F, int n, const int* parent, const int* joint_type,
    const int* q_index, const float* axis, const float* T_constant,
    const int* anc, const float* q, const float* qd, float* T16, float* Td16,
    float* J16, float* c16, void* stream) {
  if (F > kMaxFrames || n > kMaxMotors) return -1;
  if (B <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = (B + kThreads - 1) / kThreads;
  fk_derivatives_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      B, F, n, parent, joint_type, q_index, axis, T_constant, anc, q, qd, T16,
      Td16, J16, c16);
  return static_cast<int>(cudaGetLastError());
}
