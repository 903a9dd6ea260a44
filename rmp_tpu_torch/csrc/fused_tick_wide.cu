// K5's wide kernel (fused_tick_wide.cuh, whose head note holds its design
// and what bounds it), instantiated at N = 24 and 32, its launch and its C
// entry points; ops/cuda_tick.py calls them for every model past the
// 16-lane kernel's reach (fused_tick.cu). An SM holds 32 envs at F = 33
// and 24 at F = 40 (1.29 waves of 4096 envs); the launch makes the waves
// whole (whole_waves.cuh).
#include "fused_tick_wide.cuh"
#include "whole_waves.cuh"

namespace rmp_k5 {

namespace {

constexpr int kDevices = 16;  // devices whose CTA counts are kept

int cdiv(int a, int b) { return (a + b - 1) / b; }

// The CTAs an SM of each device holds at each layout's own size, by N (24,
// 32) and F (0: not asked yet).
unsigned char g_ctas[kDevices][2][kMaxFrames + 1];

// Opt in above the default 48 KB of dynamic shared memory, and give the
// SM's unified memory to shared memory: its envs hide each other's chains.
template <int N>
cudaError_t prepare(int bytes) {
  if (bytes > 48 * 1024) {
    const cudaError_t set = cudaFuncSetAttribute(
        fused_qdd_wide_kernel<N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (set != cudaSuccess) return set;
  }
  return cudaFuncSetAttribute(fused_qdd_wide_kernel<N>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// The CTAs an SM holds at the layout's own size (0 on an error).
template <int N>
int most_ctas(int F) {
  const int bytes = Layout(F, N).bytes();
  int ctas = 0;
  if (prepare<N>(bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &ctas, fused_qdd_wide_kernel<N>, kThreads, bytes) != cudaSuccess)
    return 0;
  return ctas;
}

// The dynamic shared memory a CTA of a grid of `grid` CTAs asks for: the
// layout's own, made up to whole waves (rmp::whole_wave_bytes).
template <int N>
int balanced_bytes(int F, int grid) {
  const int bytes = Layout(F, N).bytes();
  const rmp::SmShape d = rmp::current_sm_shape();
  if (d.sms == 0) return bytes;
  unsigned char& most = g_ctas[d.device][N == 24 ? 0 : 1][F];
  if (most == 0) most = static_cast<unsigned char>(most_ctas<N>(F));
  return rmp::whole_wave_bytes(bytes, most, grid, d);
}

template <int N>
int launch(int B, int F, int n, int K, int n_col, int ee_frame, int n_ident,
           const int* parent, const int* joint_type, const int* q_index,
           const float* axis, const float* T_constant, const int* anc,
           const int* col_frames, const float* caps, const int* ident,
           const float* consts, const float* q, const float* qd,
           const float* goal, const float* obs_p0, const float* obs_p1,
           const float* obs_r, float* out, cudaStream_t stream) {
  const int grid = cdiv(B, kEnvs);
  const int bytes = balanced_bytes<N>(F, grid);
  const cudaError_t set = prepare<N>(bytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  fused_qdd_wide_kernel<N><<<grid, kThreads, bytes, stream>>>(
      B, F, n, K, n_col, ee_frame, n_ident, parent, joint_type, q_index,
      axis, T_constant, anc, col_frames, caps, ident, consts, q, qd, goal,
      obs_p0, obs_p1, obs_r, out);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int envs_per_sm(int F) {
  const int ctas = most_ctas<N>(F);
  return ctas > 0 ? ctas * kEnvs : -1;
}

}  // namespace

int launch_wide(int B, int F, int n, int K, int n_col, int ee_frame,
                int n_ident, const int* parent, const int* joint_type,
                const int* q_index, const float* axis,
                const float* T_constant, const int* anc,
                const int* col_frames, const float* caps, const int* ident,
                const float* consts, const float* q, const float* qd,
                const float* goal, const float* obs_p0, const float* obs_p1,
                const float* obs_r, float* out, cudaStream_t stream) {
  return n <= 24
             ? launch<24>(B, F, n, K, n_col, ee_frame, n_ident, parent,
                          joint_type, q_index, axis, T_constant, anc,
                          col_frames, caps, ident, consts, q, qd, goal,
                          obs_p0, obs_p1, obs_r, out, stream)
             : launch<32>(B, F, n, K, n_col, ee_frame, n_ident, parent,
                          joint_type, q_index, axis, T_constant, anc,
                          col_frames, caps, ident, consts, q, qd, goal,
                          obs_p0, obs_p1, obs_r, out, stream);
}

int wide_shared_bytes(int F, int n) {
  return n <= 24 ? Layout(F, 24).bytes() : Layout(F, 32).bytes();
}

int wide_envs_per_sm(int F, int n) {
  return n <= 24 ? envs_per_sm<24>(F) : envs_per_sm<32>(F);
}

}  // namespace rmp_k5

// Dynamic shared memory of one CTA for a model of F frames, n motors and
// n_col collision frames (the layout does not depend on n_col).
extern "C" int rmp_fused_qdd_wide_shared_bytes(int F, int n, int n_col) {
  (void)n_col;
  return rmp_k5::wide_shared_bytes(F, n);
}

// The envs an SM holds at once for such a model (-1 on an error).
extern "C" int rmp_fused_qdd_wide_envs_per_sm(int F, int n, int n_col) {
  (void)n_col;
  return rmp_k5::wide_envs_per_sm(F, n);
}

// Launches on `stream` of GPU `device` (the caller's current device is
// restored); the arguments are rmp_fused_qdd_f32's. Returns
// cudaGetLastError() after the launch, or -1 when the model or env exceeds
// the kernel's capacity (1 to kMaxN motors, up to kMaxFrames frames,
// kMaxCollision collision frames and kMaxIdentity identity-space leaves;
// nothing is launched then).
extern "C" int rmp_fused_qdd_wide_f32(
    int device, int B, int F, int n, int K, int n_col, int ee_frame,
    int n_ident, const int* parent, const int* joint_type,
    const int* q_index, const float* axis, const float* T_constant,
    const int* anc, const int* col_frames, const float* caps,
    const int* ident, const float* consts, const float* q, const float* qd,
    const float* goal, const float* obs_p0, const float* obs_p1,
    const float* obs_r, float* out, void* stream) {
  if (n < 1 || n > rmp_k5::kMaxN || F > rmp_k5::kMaxFrames ||
      n_col > rmp_k5::kMaxCollision || n_ident > rmp_k5::kMaxIdentity)
    return -1;
  if (B <= 0) return 0;
  int previous = device;
  cudaGetDevice(&previous);
  if (previous != device) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  const int rc = rmp_k5::launch_wide(
      B, F, n, K, n_col, ee_frame, n_ident, parent, joint_type, q_index,
      axis, T_constant, anc, col_frames, caps, ident, consts, q, qd, goal,
      obs_p0, obs_p1, obs_r, out, static_cast<cudaStream_t>(stream));
  if (previous != device) cudaSetDevice(previous);
  return rc;
}
