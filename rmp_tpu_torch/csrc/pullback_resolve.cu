// K1: fused RMP pullback + pivoted-LU resolve, one thread per environment.
//
// Replaces the TPU kernel
// rmp_tpu/ops/pallas_resolve.py::pullback_resolve_structured
// (_kernel_structured, _lu_solve_lanes). Per environment b it accumulates
//   A = A0 + sum_dense J^T W + sum_scalar J^T diag(m) J      (n x n)
//   f = f0 + sum_dense J^T v + sum_scalar J^T v
// (A0, f0: the identity-taskmap blocks, pre-summed by the wrapper; the
// scalar block's W = m J is formed in registers and only the upper triangle
// of J^T diag(m) J is accumulated, then mirrored), adds the ridge, and solves
// A x = f by unrolled Gaussian elimination with partial pivoting and
// sign-preserving clamps (|pivot|, |diagonal| >= 1e-12). Plain version:
// ops/cuda_resolve.pullback_resolve_structured_plain.
//
// Tie and clamp rules of the TPU kernel, kept exactly: a row replaces the
// running pivot only if its magnitude is STRICTLY greater, and the displaced
// row takes the candidate's place; every pivot and every back-substitution
// diagonal goes through safe_denom.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. In the flagship layout (n = 9;
// identity seed 90 floats, dense block 57, scalar block 770; output 9) the
// kernel moves ~926 floats per env, ~15.2 MB at B = 4096, so ~4.5 us; the
// ~10 kFLOP per env are negligible. Design: n is a template parameter, so
// the 81 + 9 accumulators and the whole elimination are unrolled into
// registers. The wrapper hands over batch-minor copies ((R, n, B) and
// (R, B)), so at every load neighbouring threads read neighbouring addresses;
// the copies cost one extra pass over the blocks, counted in the wrapper's
// time.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float safe_denom(float d) {
  const float eps = 1e-12f;
  return d >= 0.0f ? fmaxf(d, eps) : fminf(d, -eps);
}

template <int N>
__global__ void __launch_bounds__(kThreads) pullback_resolve_kernel(
    int B, const float* __restrict__ A0, const float* __restrict__ f0,
    int Rd, const float* __restrict__ Jd, const float* __restrict__ Wd,
    const float* __restrict__ vd, int Rs, const float* __restrict__ Js,
    const float* __restrict__ ms, const float* __restrict__ vs, float ridge,
    float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);

  float A[N][N];
  float f[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    f[i] = A0 != nullptr ? f0[i * sB + b] : 0.0f;
#pragma unroll
    for (int j = 0; j < N; ++j)
      A[i][j] = A0 != nullptr ? A0[(i * N + j) * sB + b] : 0.0f;
  }

  // dense block: A += J^T W, f += J^T v
  for (int r = 0; r < Rd; ++r) {
    float J[N], Wr[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      J[i] = Jd[(static_cast<size_t>(r) * N + i) * sB + b];
      Wr[i] = Wd[(static_cast<size_t>(r) * N + i) * sB + b];
    }
    const float v = vd[r * sB + b];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      f[i] += J[i] * v;
#pragma unroll
      for (int j = 0; j < N; ++j) A[i][j] += J[i] * Wr[j];
    }
  }

  // scalar block: A += J^T diag(m) J (upper triangle, mirrored), f += J^T v
  for (int r = 0; r < Rs; ++r) {
    float J[N];
#pragma unroll
    for (int i = 0; i < N; ++i)
      J[i] = Js[(static_cast<size_t>(r) * N + i) * sB + b];
    const float m = ms[r * sB + b];
    const float v = vs[r * sB + b];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      f[i] += J[i] * v;
      const float Jm = J[i] * m;
#pragma unroll
      for (int j = i; j < N; ++j) {
        const float a = Jm * J[j];
        A[i][j] += a;
        if (j > i) A[j][i] += a;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < N; ++i) A[i][i] += ridge;

  // elimination with partial pivoting; rows k..N-1, columns k..N-1 plus f
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float piv_mag = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      const float mag = fabsf(A[i][k]);
      const bool take = mag > piv_mag;
#pragma unroll
      for (int c = k; c < N; ++c) {
        const float p = A[k][c], q = A[i][c];
        A[k][c] = take ? q : p;
        A[i][c] = take ? p : q;
      }
      const float p = f[k], q = f[i];
      f[k] = take ? q : p;
      f[i] = take ? p : q;
      piv_mag = take ? mag : piv_mag;
    }
    const float inv_pivot = 1.0f / safe_denom(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      const float factor = A[i][k] * inv_pivot;
#pragma unroll
      for (int c = k; c < N; ++c) A[i][c] -= factor * A[k][c];
      f[i] -= factor * f[k];
    }
  }

  float x[N];
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float s = f[i];
#pragma unroll
    for (int j = i + 1; j < N; ++j) s -= A[i][j] * x[j];
    x[i] = s / safe_denom(A[i][i]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) out[static_cast<size_t>(b) * N + i] = x[i];
}

template <int N>
void launch(int B, const float* A0, const float* f0, int Rd, const float* Jd,
            const float* Wd, const float* vd, int Rs, const float* Js,
            const float* ms, const float* vs, float ridge, float* out,
            cudaStream_t stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  pullback_resolve_kernel<N><<<blocks, kThreads, 0, stream>>>(
      B, A0, f0, Rd, Jd, Wd, vd, Rs, Js, ms, vs, ridge, out);
}

}  // namespace

// Inputs are batch-minor: A0 (n, n, B), f0 (n, B), Jd/Wd/Js (R, n, B),
// vd/ms/vs (R, B); A0/f0 may be null (no identity blocks) and R may be 0.
// Output: (B, n). Launches on `stream` of GPU `device`. Returns
// cudaGetLastError() after the launch, or -1 when no kernel is instantiated
// for this n (nothing is launched then).
extern "C" int rmp_pullback_resolve_f32(
    int device, int n, int B, const float* A0, const float* f0, int Rd,
    const float* Jd, const float* Wd, const float* vd, int Rs,
    const float* Js, const float* ms, const float* vs, float ridge,
    float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  switch (n) {
    case 9:
      if (B > 0) launch<9>(B, A0, f0, Rd, Jd, Wd, vd, Rs, Js, ms, vs, ridge, out, s);
      break;
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
