// The launch of K3's wide kernel (fk_derivatives_wide.cuh) at one
// instantiation (kMaxFrames, kMaxMotors, kEnvs), for fk_derivatives_wide.cu
// and fk_derivatives_xl.cu: the CTAs an SM holds at each layout's own size,
// asked of the occupancy calculator once per (device, F, n), and whole waves
// (whole_waves.cuh).
#pragma once

#include <cuda_runtime.h>

#include "fk_derivatives_wide.cuh"
#include "whole_waves.cuh"

namespace rmp_k3 {

template <int kMaxFrames, int kMaxMotors, int kEnvs>
struct WideLaunch {
  static constexpr int kThreads = 16 * kEnvs;
  static constexpr int kDevices = 16;  // devices whose CTA counts are kept

  static int cdiv(int a, int b) { return (a + b - 1) / b; }

  // Opt in above the default 48 KB of dynamic shared memory, and give the
  // SM's unified memory to shared memory: its envs hide the steps' latency.
  static cudaError_t prepare(int bytes) {
    if (bytes > 48 * 1024) {
      const cudaError_t set = cudaFuncSetAttribute(
          fk_derivatives_kernel_wide<kMaxFrames, kMaxMotors, kEnvs>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (set != cudaSuccess) return set;
    }
    return cudaFuncSetAttribute(
        fk_derivatives_kernel_wide<kMaxFrames, kMaxMotors, kEnvs>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
  }

  // The CTAs an SM holds at the layout's own size (0 on an error).
  static int most_ctas(int F, int n) {
    const int bytes = WideLayout(F, n).bytes(kEnvs);
    int ctas = 0;
    if (prepare(bytes) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &ctas, fk_derivatives_kernel_wide<kMaxFrames, kMaxMotors, kEnvs>,
            kThreads, bytes) != cudaSuccess)
      return 0;
    return ctas;
  }

  // The dynamic shared memory a CTA of a grid of `grid` CTAs asks for: the
  // layout's own, made up to whole waves (rmp::whole_wave_bytes).
  static int balanced_bytes(int F, int n, int grid) {
    // the CTAs an SM of each device holds at each layout's own size (0: not
    // asked yet)
    static unsigned char most_at[kDevices][kMaxFrames + 1][kMaxMotors + 1];
    const int bytes = WideLayout(F, n).bytes(kEnvs);
    const rmp::SmShape d = rmp::current_sm_shape();
    if (d.sms == 0) return bytes;
    unsigned char& most = most_at[d.device][F][n];
    if (most == 0) most = static_cast<unsigned char>(most_ctas(F, n));
    return rmp::whole_wave_bytes(bytes, most, grid, d);
  }

  static int launch(int B, int F, int n, const int* parent,
                    const int* joint_type, const int* q_index,
                    const float* axis, const float* T_constant,
                    const int* anc, const float* q, const float* qd,
                    float* T16, float* Td16, float* J16, float* c16,
                    cudaStream_t stream) {
    const int grid = cdiv(B, kEnvs);
    const int bytes = balanced_bytes(F, n, grid);
    const cudaError_t set = prepare(bytes);
    if (set != cudaSuccess) return static_cast<int>(set);
    fk_derivatives_kernel_wide<kMaxFrames, kMaxMotors, kEnvs>
        <<<grid, kThreads, bytes, stream>>>(B, F, n, parent, joint_type,
                                            q_index, axis, T_constant, anc,
                                            q, qd, T16, Td16, J16, c16);
    return static_cast<int>(cudaGetLastError());
  }

  static int shared_bytes(int F, int n) {
    return WideLayout(F, n).bytes(kEnvs);
  }

  static int envs_per_sm(int F, int n) {
    const int ctas = most_ctas(F, n);
    return ctas > 0 ? ctas * kEnvs : -1;
  }
};

}  // namespace rmp_k3
