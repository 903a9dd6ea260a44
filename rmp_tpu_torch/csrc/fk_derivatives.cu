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
// frames and kMaxMotors motors. Each thread walks the tree in BFS order
// (rmp::fk_step of fk_common.cuh, shared with K5) and keeps T, W, Wd and G
// of every frame in per-thread arrays; indexed by a
// run-time frame number they live in local memory (L1-cached), which this
// first version accepts. Each frame's outputs are written as soon as the
// frame is done. The writes are batch-major (the contract of the TPU kernel's
// wrapper), so neighbouring threads write 9 KB apart: the stores are not
// coalesced and the kernel is expected to sit well above its bound. Making it
// coalesced (staging rows through shared memory) is later work.
#include <cuda_runtime.h>

#include "fk_common.cuh"

namespace {

using rmp::kMaxFrames;
using rmp::kMaxMotors;
using rmp::mm44;

constexpr int kThreads = 128;

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

  for (int f = 0; f < F; ++f) {
    rmp::fk_step(f, parent, joint_type, q_index, axis, T_constant,
                 q + (size_t)b * n, qd + (size_t)b * n, T, W, Wd, G);

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
