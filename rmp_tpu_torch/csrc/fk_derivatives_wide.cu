// K3's wide kernel (fk_derivatives_wide.cuh, whose head note holds its
// design and what bounds it), instantiated at its capacity (40 frames, 32
// motors, kWideEnvs envs a CTA), and its launch; fk_derivatives.cu's
// launcher calls it for every model past the narrow tile.
//
// Whole waves. An SM holds as many CTAs as the layout's shared memory
// lets it (32 envs at F = 33, n = 32; 24 at F = 40). Where the grid needs
// more than that, the last wave is part-filled, and its few envs an SM
// each take a whole env's chain of frame steps with the memory rate to
// spare (0.1652 ms at F = 40, n = 32, B = 4096: 1.29 waves of 24 envs an
// SM). So the launch asks for more shared memory than the layout needs
// where that keeps the number of waves and makes them whole: the fewest
// CTAs an SM that take the grid in as many waves as the most would.
#include "fk_derivatives_wide.cuh"

namespace rmp_k3 {

namespace {

constexpr int kThreads = 16 * kWideEnvs;
constexpr int kDevices = 16;  // devices whose attributes are kept

int cdiv(int a, int b) { return (a + b - 1) / b; }

// A device's SM count, shared memory an SM and its part reserved a CTA;
// the CTAs an SM holds at each layout's own size (0: not asked yet).
struct Device {
  int sms = 0, smem = 0, reserved = 0;
  unsigned char ctas[kWideFrames + 1][kWideMotors + 1] = {};
};
Device g_device[kDevices];

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
// layout's own, or, where the grid takes more than one wave, enough that
// no more CTAs fit an SM than the fewest that keep the number of waves.
int balanced_bytes(int F, int n, int grid) {
  const int bytes = WideLayout(F, n).bytes(kWideEnvs);
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kDevices)
    return bytes;
  Device& d = g_device[dev];
  if (d.sms == 0) {
    int smem = 0, reserved = 0, sms = 0;
    if (cudaDeviceGetAttribute(
            &smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(
            &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return bytes;
    d.smem = smem;
    d.reserved = reserved;
    d.sms = sms;
  }
  if (d.ctas[F][n] == 0) d.ctas[F][n] = static_cast<unsigned char>(
      most_ctas(F, n));
  const int most = d.ctas[F][n];
  const int need = cdiv(grid, d.sms);  // CTAs an SM takes in all
  if (most <= 0 || need <= most) return bytes;
  const int fewest = cdiv(need, cdiv(need, most));
  if (fewest >= most) return bytes;
  // the least size, in 128-byte units, at which fewest + 1 CTAs no longer
  // fit an SM
  const int padded =
      (d.smem / (fewest + 1) - d.reserved + 1 + 127) / 128 * 128;
  return padded > bytes ? padded : bytes;
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
