// K3's wide kernel (fk_derivatives_wide.cuh) instantiated again at 72
// frames and 64 motors (kXl*: four motors a lane, kXlEnvs envs a CTA), and
// its launch (fk_wide_launch.cuh); fk_derivatives.cu's launcher calls it for
// every model past the wide tile (40 frames, 32 motors) up to that capacity:
// four Pandas (F = 52, n = 36), the 64-link arm (F = 65, n = 64).
#include "fk_wide_launch.cuh"

namespace rmp_k3 {

namespace {
// fk_derivatives_kernel_wide<kXlFrames, kXlMotors, kXlEnvs>
using Xl = WideLaunch<kXlFrames, kXlMotors, kXlEnvs>;
}  // namespace

int launch_xl(int B, int F, int n, const int* parent, const int* joint_type,
              const int* q_index, const float* axis, const float* T_constant,
              const int* anc, const float* q, const float* qd, float* T16,
              float* Td16, float* J16, float* c16, cudaStream_t stream) {
  return Xl::launch(B, F, n, parent, joint_type, q_index, axis, T_constant,
                    anc, q, qd, T16, Td16, J16, c16, stream);
}

int xl_shared_bytes(int F, int n) { return Xl::shared_bytes(F, n); }

int xl_envs_per_sm(int F, int n) { return Xl::envs_per_sm(F, n); }

}  // namespace rmp_k3
