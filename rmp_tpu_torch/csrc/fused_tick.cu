// K5's 16-lane kernel (fused_tick.cuh, whose head note holds its design)
// for n = 1..9, and the C entry points that dispatch every n = 1..16 (the
// other instantiations: fused_tick_10.cu, fused_tick_14.cu).
#include "fused_tick.cuh"

// Dynamic shared memory of one CTA for a model of F frames, n motors and
// n_col collision frames.
extern "C" int rmp_fused_qdd_shared_bytes(int F, int n, int n_col) {
  return Layout(F, n, n_col).bytes();
}

// Launches on `stream` of GPU `device` (the caller's current device is
// restored). Returns cudaGetLastError() after the launch, or -1 when the
// model or env exceeds the kernel's capacity (1 to kMaxN motors, up to
// kMaxFrames frames, kMaxCollision collision frames and kMaxIdentity
// identity-space leaves; nothing is launched then).
extern "C" int rmp_fused_qdd_f32(
    int device, int B, int F, int n, int K, int n_col, int ee_frame,
    int n_ident, const int* parent, const int* joint_type,
    const int* q_index, const float* axis, const float* T_constant,
    const int* anc, const int* col_frames, const float* caps,
    const int* ident, const float* consts, const float* q, const float* qd,
    const float* goal, const float* obs_p0, const float* obs_p1,
    const float* obs_r, float* out, void* stream) {
  if (n < 1 || n > kMaxN || F > kMaxFrames || n_col > kMaxCollision ||
      n_ident > kMaxIdentity)
    return -1;
  if (B <= 0) return 0;
  int previous = device;
  cudaGetDevice(&previous);
  if (previous != device) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  const rmp_k5::NarrowLaunch a{B,          F,      K,          n_col,  ee_frame,
                               n_ident,    parent, joint_type, q_index, axis,
                               T_constant, anc,    col_frames, caps,   ident,
                               consts,     q,      qd,         goal,   obs_p0,
                               obs_p1,     obs_r,  out,
                               static_cast<cudaStream_t>(stream)};
  if (n <= 9)
    launch_range<1, 9>(n, a);
  else if (n <= 13)
    rmp_k5::launch_narrow_10(n, a);
  else
    rmp_k5::launch_narrow_14(n, a);
  const int rc = static_cast<int>(cudaGetLastError());
  if (previous != device) cudaSetDevice(previous);
  return rc;
}
