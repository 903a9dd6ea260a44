// K3's wide kernel (fk_derivatives_wide.cuh, whose head note holds its
// design and what bounds it), instantiated at its capacity (40 frames, 32
// motors, kWideEnvs envs a CTA), and its launch; fk_derivatives.cu's
// launcher calls it for every model past the narrow tile. An SM holds 32
// envs at F = 33, n = 32 and 24 at F = 40; the launch makes the waves
// whole (whole_waves.cuh).
#include "fk_derivatives_wide.cuh"
#include "whole_waves.cuh"

namespace rmp_k3 {

namespace {

constexpr int kThreads = 16 * kWideEnvs;
constexpr int kDevices = 16;  // devices whose CTA counts are kept

int cdiv(int a, int b) { return (a + b - 1) / b; }

// The CTAs an SM of each device holds at each layout's own size (0: not
// asked yet).
unsigned char g_ctas[kDevices][kWideFrames + 1][kWideMotors + 1];

// Opt in above the default 48 KB of dynamic shared memory, and give the
// SM's unified memory to shared memory: its envs hide the steps' latency.
cudaError_t prepare(int bytes) {
  if (bytes > 48 * 1024) {
    const cudaError_t set = cudaFuncSetAttribute(
        fk_derivatives_kernel_wide<kWideFrames, kWideMotors, kWideEnvs>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (set != cudaSuccess) return set;
  }
  return cudaFuncSetAttribute(
      fk_derivatives_kernel_wide<kWideFrames, kWideMotors, kWideEnvs>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
}

// The CTAs an SM holds at the layout's own size (0 on an error).
int most_ctas(int F, int n) {
  const int bytes = WideLayout(F, n).bytes(kWideEnvs);
  int ctas = 0;
  if (prepare(bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &ctas,
          fk_derivatives_kernel_wide<kWideFrames, kWideMotors, kWideEnvs>,
          kThreads, bytes) != cudaSuccess)
    return 0;
  return ctas;
}

// The dynamic shared memory a CTA of a grid of `grid` CTAs asks for: the
// layout's own, made up to whole waves (rmp::whole_wave_bytes).
int balanced_bytes(int F, int n, int grid) {
  const int bytes = WideLayout(F, n).bytes(kWideEnvs);
  const rmp::SmShape d = rmp::current_sm_shape();
  if (d.sms == 0) return bytes;
  unsigned char& most = g_ctas[d.device][F][n];
  if (most == 0) most = static_cast<unsigned char>(most_ctas(F, n));
  return rmp::whole_wave_bytes(bytes, most, grid, d);
}

}  // namespace

int launch_wide(int B, int F, int n, const int* parent, const int* joint_type,
                const int* q_index, const float* axis, const float* T_constant,
                const int* anc, const float* q, const float* qd, float* T16,
                float* Td16, float* J16, float* c16, cudaStream_t stream) {
  const int grid = cdiv(B, kWideEnvs);
  const int bytes = balanced_bytes(F, n, grid);
  const cudaError_t set = prepare(bytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  fk_derivatives_kernel_wide<kWideFrames, kWideMotors, kWideEnvs>
      <<<grid, kThreads, bytes, stream>>>(B, F, n, parent, joint_type,
                                          q_index, axis, T_constant, anc, q,
                                          qd, T16, Td16, J16, c16);
  return static_cast<int>(cudaGetLastError());
}

int wide_shared_bytes(int F, int n) {
  return WideLayout(F, n).bytes(kWideEnvs);
}

int wide_envs_per_sm(int F, int n) {
  const int ctas = most_ctas(F, n);
  return ctas > 0 ? ctas * kWideEnvs : -1;
}

}  // namespace rmp_k3
