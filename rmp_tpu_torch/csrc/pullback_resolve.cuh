// K1's shared pieces: the block descriptor table the wrapper passes by
// value, the element loads (float32, bfloat16 widened on load), the
// sign-preserving clamp, and the staging by cp.async that the warp and CTA
// kernels share. pullback_resolve.cu (n <= 9, and the C entry
// point), pullback_resolve_wide*.cu (n = 10..32) and
// pullback_resolve_cta*.cu (n = 33..64) include it.
#pragma once

#include <cuda_runtime.h>

namespace rmp_k1 {

constexpr int kMaxLaneN = 9;    // n of the lane-group kernel; above, a warp
constexpr int kMaxWarpN = 32;   // n of the warp kernel: one row per lane
constexpr int kMaxN = 64;       // n of the CTA kernel: two rows a lane
// descriptors per call; the by-value table (3,592 bytes) stays inside the
// 4 KB of kernel parameters every CUDA version takes
constexpr int kMaxBlocks = 32;
constexpr int kIdentity = 0, kScalar = 1, kDense = 2;
constexpr int kFloat32 = 0, kBFloat16 = 1;  // element types

// One policy block: identity (M (B, n, n), v (B, n)), scalar (J (B, R, n),
// m (B, R), v (B, R)) or dense (J (B, R, n), W (B, R, n), v (B, R)), all
// of element type `elem`.
struct Block {
  int kind;
  int rows;
  int elem;
  const void* ptr[3];
  long long stride[3][3];  // (batch, row, column) of each tensor, elements
};

struct Table {
  int count;
  Block block[kMaxBlocks];
};

__device__ __forceinline__ float safe_denom(float d) {
  const float eps = 1e-12f;
  return d >= 0.0f ? fmaxf(d, eps) : fminf(d, -eps);
}

// A bfloat16 element: the high 16 bits of the float32 of the same value.
struct bf16_t {
  unsigned short bits;
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const bf16_t* p) {
  const unsigned short h = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(h) << 16);
}

// Element (b, r, c) of a block tensor of element type T, as float32.
template <class T>
__device__ __forceinline__ float at(const void* p, const long long* s,
                                    long long b, long long r, long long c) {
  return load(static_cast<const T*>(p) + b * s[0] + r * s[1] + c * s[2]);
}
// The same for the block's element type read at run time.
__device__ __forceinline__ float at(const void* p, int elem,
                                    const long long* s, long long b,
                                    long long r, long long c) {
  return elem == kBFloat16 ? at<bf16_t>(p, s, b, r, c)
                           : at<float>(p, s, b, r, c);
}

// safe_denom as the reference and the plain version write it,
// where(d >= 0, max(d, eps), min(d, -eps)), a NaN kept (fminf would drop it)
__device__ __forceinline__ float clamp_ref(float d) {
  return d != d ? d : safe_denom(d);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// One element into shared memory: float32 by cp.async, bfloat16 widened
// through a register.
__device__ __forceinline__ void copy(float* dst, const float* src) {
  cp_async4(dst, src);
}
__device__ __forceinline__ void copy(float* dst, const bf16_t* src) {
  *dst = load(src);
}

// n = 10..kMaxWarpN on the warp kernel (pullback_resolve_wide.cuh;
// instantiated in pullback_resolve_wide.cu, n = 10..13, and in
// pullback_resolve_wide_<lo>.cu from n = lo on): launches on `stream`,
// returns nothing; the caller reads cudaGetLastError().
void launch_wide(int n, int B, const Table& table, float ridge, float* out,
                 cudaStream_t stream);
void launch_wide_14(int n, int B, const Table& table, float ridge,
                    float* out, cudaStream_t stream);
void launch_wide_18(int n, int B, const Table& table, float ridge,
                    float* out, cudaStream_t stream);
void launch_wide_22(int n, int B, const Table& table, float ridge,
                    float* out, cudaStream_t stream);
void launch_wide_25(int n, int B, const Table& table, float ridge,
                    float* out, cudaStream_t stream);
void launch_wide_28(int n, int B, const Table& table, float ridge,
                    float* out, cudaStream_t stream);
void launch_wide_31(int n, int B, const Table& table, float ridge,
                    float* out, cudaStream_t stream);
// n = kMaxWarpN + 1..kMaxN on the CTA kernel (pullback_resolve_cta.cuh,
// instantiated in pullback_resolve_cta.cu, n <= 40, and
// pullback_resolve_cta_64.cu, n = 41..64); launches likewise.
// residency_cta_64: the shared bytes a CTA and the CTAs an SM of the
// kMaxN = 64 kernel at B envs, and 64, into out[0..2].
void launch_cta(int n, int B, const Table& table, float ridge, float* out,
                cudaStream_t stream);
void launch_cta_64(int n, int B, const Table& table, float ridge, float* out,
                   cudaStream_t stream);
void residency_cta_64(int B, int* out);

}  // namespace rmp_k1
