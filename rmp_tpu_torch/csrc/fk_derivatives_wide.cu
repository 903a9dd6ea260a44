// K3's wide kernel (fk_derivatives_wide.cuh, whose head note holds its
// design and what bounds it), instantiated at its capacity (40 frames, 32
// motors, kWideEnvs envs a CTA), and its launch (fk_wide_launch.cuh);
// fk_derivatives.cu's launcher calls it for every model past the narrow
// tile up to that capacity. An SM holds 32 envs at F = 33, n = 32 and 24 at
// F = 40; the launch makes the waves whole (whole_waves.cuh).
#include "fk_wide_launch.cuh"

namespace rmp_k3 {

namespace {
// fk_derivatives_kernel_wide<kWideFrames, kWideMotors, kWideEnvs>
using Wide = WideLaunch<kWideFrames, kWideMotors, kWideEnvs>;
}  // namespace

int launch_wide(int B, int F, int n, const int* parent, const int* joint_type,
                const int* q_index, const float* axis, const float* T_constant,
                const int* anc, const float* q, const float* qd, float* T16,
                float* Td16, float* J16, float* c16, cudaStream_t stream) {
  return Wide::launch(B, F, n, parent, joint_type, q_index, axis, T_constant,
                      anc, q, qd, T16, Td16, J16, c16, stream);
}

int wide_shared_bytes(int F, int n) { return Wide::shared_bytes(F, n); }

int wide_envs_per_sm(int F, int n) { return Wide::envs_per_sm(F, n); }

}  // namespace rmp_k3
