// K3: batched closed-form FK derivatives, a tile of environments per CTA.
//
// Replaces the TPU kernel rmp_tpu/ops/pallas_fk.py::fk_derivatives_batched
// (_build / _make_kernel). For every frame f of a kinematic tree it computes
//   T_f            world transform
//   Td_f = W_f T_f                       (velocity, W = sum of qd_j G_j)
//   c_f  = (Wd_f + W_f W_f) T_f          (curvature at qdd = 0)
//   J_f[:, m] = G_j T_f                  (Jacobian column of motor m whose
//                                          joint j is an ancestor of f)
// with the world twist generators G_j = A_j E_j A_j^{-1}, A_j the parent-side
// rigid transform of joint j (the recursion of fk_common.cuh). Plain
// version: models/fk_derivatives.py.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32): bytes. At the Panda
// (F = 12, n = 9) an env reads q, qd (18 floats) and writes 2,304 (T, Td, c:
// 3 x 12 x 16; J: 12 x 16 x 9): 38.0 MB at B = 4096, 11.4 us. Its ~40
// kFLOP of 4x4 products take ~2.5 us at the fp32 peak. So the kernel's job
// is to store 38 MB at close to the memory rate. At the 32-link planar arm
// (F = 33, n = 32) it stores 304 MB at B = 4096 (J alone 277 MB), 90.7 us.
//
// Design.
// - A CTA takes a tile of kEnvs consecutive envs; the last tile is masked.
// - The kernel is a template on its capacity (kMaxFrames, kMaxMotors) and
//   its tile, instantiated here once (kTiles[0]: 32 frames, 18 motors, 8
//   envs), which serves every robot up to the dual-arm Panda (F = 26,
//   n = 18). The rest up to 40 frames and 32 motors, K1's ceiling (the
//   N-link arms: F = 25, n = 24 and F = 33, n = 32), go to the wide
//   kernel (kTiles[1], fk_derivatives_wide.cuh: a design of its own, which
//   stores each frame's rows as its step ends), and the rest up to 72
//   frames and 64 motors (four Pandas, the 64-link arm) to the same kernel
//   instantiated at that capacity (kTiles[2], fk_derivatives_xl.cu). The
//   launcher takes the first tile that fits; past the last it launches
//   nothing and returns -1.
// - The model's tables (parent, joint type, motor index, axis, constant
//   transforms, ancestor table anc[f][m]) and the tile's q, qd are loaded
//   into shared memory once per CTA, each thread issuing its loads of every
//   table before its first shared store (an instantiation whose ancestor
//   table would take more than kMaxAncPreload registers a thread copies
//   it in a loop instead).
// - Shared memory is ~12-13 KB per env at 26-33 frames (Layout(26, 18):
//   97,440 bytes per CTA of 8, opted in above the 48 KB default). At the
//   dual-arm Panda 8 envs and 4 fit the same 16 envs on an SM, so the
//   narrow tile stays 8. At F = 33, n = 32 a CTA of 8 envs takes 123,128
//   bytes and only one fits an SM (8 envs), while CTAs of 4 (66,504 bytes)
//   fit three (12 envs); at F = 25, n = 24 both tiles fit 16 envs (this
//   layout; the wide kernel has its own).
// - The recursion runs on 16 threads per env, thread (i, j) owning entry
//   (i, j) of every 4x4 product; the 16 threads of an env sit in one half
//   warp, so __syncwarp orders them. T (and its transpose), W, Wd and G of
//   every frame live in shared memory (~5 x F x 16 floats per env), not
//   in a per-thread local frame (fk_common.cuh's fk_recursion, which K5
//   runs too). Each entry sums a[4i] b[j] first, then k = 1..3. The
//   per-frame work that all 16 lanes would
//   repeat (sincos, the joint motion Tv, the generator E) runs once per
//   (env, frame) in a prologue, one lane each, and is kept transposed, so
//   a step reads a column as one float4 and its lanes never diverge. The
//   env stride of each array is 16 mod 32 floats, so the two envs of a
//   warp read the same entry from different banks.
// - After a __syncthreads the whole CTA writes the tile's outputs in their
//   own memory order, one float4 per thread and step: a tile's rows of each
//   output are one contiguous, 16-byte aligned range, so consecutive
//   threads store consecutive 16 bytes and every warp store is 512
//   coalesced bytes. A J row holds 16 n floats, 4 n float4s, for any n; a
//   float4 may span two entries' motor ranges when n is not a multiple of
//   4. A J element is row i of G[anc[f][m]] dotted with row j
//   of T_f's transpose (float4 shared loads; the generators at a padded
//   pitch, so a quarter warp's rows hit distinct bank groups, and T_f's
//   column kept while a float4's elements share it); Td and c take a row of
//   W or of Wd + W W against the same transposed rows. Staging the tile for
//   a TMA bulk store was the alternative: the J tile alone is 55 KB, so
//   shared memory would cap residency, and the plain stores are already
//   full-width.
#include <cuda_runtime.h>

#include "fk_common.cuh"
#include "fk_derivatives_wide.cuh"

namespace {

using rmp::col4;
using rmp::dot4;
using rmp::kGPitch;
using rmp::ld4;
using rmp::odd_half;

// The instantiations, first fit first: (frames, motors, envs per CTA).
struct Tile {
  int frames, motors, envs;
};
constexpr Tile kTiles[] = {{32, 18, 8}, {40, 32, 4}, {72, 64, 2}};
static_assert(kTiles[1].frames == rmp_k3::kWideFrames &&
                  kTiles[1].motors == rmp_k3::kWideMotors &&
                  kTiles[1].envs == rmp_k3::kWideEnvs,
              "kTiles[1] is the wide kernel's tile");
static_assert(kTiles[2].frames == rmp_k3::kXlFrames &&
                  kTiles[2].motors == rmp_k3::kXlMotors &&
                  kTiles[2].envs == rmp_k3::kXlEnvs,
              "kTiles[2] is the wide kernel's second instantiation");

__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}
// Float offsets of the shared-memory arrays, then the int tables. Per env:
// T, its transpose Tt, W, C (Wd, then Wd + W W) and the joint motions'
// transposes Tv, F x 16 floats each at env stride `tstride`; the
// generators at pitch kGPitch and env stride `gstride`. Per model: the
// constant transforms Tc and the joint generators' transposes Et. The store
// pass's tables: goff[f n + m], the offset of
// G[anc[f][m]] among an env's generators (-1: no ancestor, a zero column);
// for the tile's row ef = e F + f, frame[ef] = f, trow[ef] = its T/Tt/W/C
// offset and gbase[ef] its env's generator offset; elem[w] = (rr << 8) | m,
// the first element of float4 w of a J row.
template <int kEnvs>
struct Layout {
  int tstride, gstride;
  int T, Tt, W, C, Tv, G, scratch, Tc, Et, eye, axis, q, qd, floats;
  int parent, type, qidx, goff, frame, trow, gbase, elem, ints;
  __host__ __device__ constexpr Layout(int F, int n)
      : tstride(odd_half(16 * F)), gstride(odd_half(kGPitch * F)), T(0),
        Tt(kEnvs * tstride), W(2 * kEnvs * tstride), C(3 * kEnvs * tstride),
        Tv(4 * kEnvs * tstride), G(5 * kEnvs * tstride),
        scratch(G + kEnvs * gstride), Tc(scratch + kEnvs * 48),
        Et(Tc + F * 16), eye(Et + F * 16), axis(eye + 32),
        q(axis + 3 * F), qd(q + kEnvs * n), floats(qd + kEnvs * n),
        parent(0), type(F), qidx(2 * F), goff(3 * F), frame(goff + F * n),
        trow(frame + kEnvs * F), gbase(trow + kEnvs * F),
        elem(gbase + kEnvs * F), ints(elem + 4 * n) {}
  __host__ __device__ constexpr int bytes() const {
    return 4 * (floats + ints);
  }
};

// The ancestor table's preload stays in registers up to this many entries
// a thread; a larger one is copied in a loop.
constexpr int kMaxAncPreload = 8;

template <int kMaxFrames, int kMaxMotors, int kEnvs>
__global__ void __launch_bounds__(16 * kEnvs) fk_derivatives_kernel(
    int B, int F, int n, const int* __restrict__ parent,
    const int* __restrict__ joint_type, const int* __restrict__ q_index,
    const float* __restrict__ axis, const float* __restrict__ T_constant,
    const int* __restrict__ anc, const float* __restrict__ q,
    const float* __restrict__ qd, float* __restrict__ T16,
    float* __restrict__ Td16, float* __restrict__ J16,
    float* __restrict__ c16) {
  constexpr int kThreads = 16 * kEnvs;  // one thread per 4x4 entry and env
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout<kEnvs> L(F, n);
  int* imem = reinterpret_cast<int*>(smem + L.floats);
  const int* s_parent = imem + L.parent;
  const int* s_qidx = imem + L.qidx;
  const int* s_goff = imem + L.goff;
  const int* s_frame = imem + L.frame;
  const int* s_trow = imem + L.trow;
  const int* s_gbase = imem + L.gbase;
  const int* s_elem = imem + L.elem;

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kEnvs;
  const int nv = min(kEnvs, B - b0);  // envs of this tile

  // the model's tables and the tile's q, qd: every global load is issued
  // before the first shared store, so they are in flight together (a
  // table's kL* loads per thread, those past its end predicated off)
  constexpr int kLTc = cdiv(16 * kMaxFrames, kThreads);
  constexpr int kLAnc = cdiv(kMaxFrames * kMaxMotors, kThreads);
  constexpr bool kAncPreload = kLAnc <= kMaxAncPreload;
  constexpr int kLAncRegs = kAncPreload ? kLAnc : 1;
  constexpr int kLQ = cdiv(kEnvs * kMaxMotors, kThreads);
  constexpr int kLAxis = cdiv(3 * kMaxFrames, kThreads);
  const size_t q0 = static_cast<size_t>(b0) * n;
  float tc[kLTc], qv[kLQ], qdv[kLQ], axv[kLAxis];
  int an[kLAncRegs];
#pragma unroll
  for (int t = 0; t < kLTc; ++t) {
    const int k = tid + t * kThreads;
    tc[t] = k < F * 16 ? T_constant[k] : 0.0f;
  }
  if constexpr (kAncPreload) {
#pragma unroll
    for (int t = 0; t < kLAnc; ++t) {
      const int k = tid + t * kThreads;
      an[t] = k < F * n ? anc[k] : -1;
    }
  }
#pragma unroll
  for (int t = 0; t < kLQ; ++t) {
    const int k = tid + t * kThreads;
    const bool in = k < nv * n;  // masked envs run on zeros, store nothing
    qv[t] = in ? q[q0 + k] : 0.0f;
    qdv[t] = in ? qd[q0 + k] : 0.0f;
  }
#pragma unroll
  for (int t = 0; t < kLAxis; ++t) {
    const int k = tid + t * kThreads;
    axv[t] = k < 3 * F ? axis[k] : 0.0f;
  }
  // one frame per thread: kThreads >= kMaxFrames in both instantiations
  static_assert(kMaxFrames <= kThreads, "one thread per frame of the model");
  const int par = tid < F ? parent[tid] : 0;
  const int typ = tid < F ? joint_type[tid] : 0;
  const int qix = tid < F ? q_index[tid] : 0;
#pragma unroll
  for (int t = 0; t < kLTc; ++t) {
    const int k = tid + t * kThreads;
    if (k < F * 16) smem[L.Tc + k] = tc[t];
  }
  if constexpr (kAncPreload) {
#pragma unroll
    for (int t = 0; t < kLAnc; ++t) {
      const int k = tid + t * kThreads;
      if (k < F * n) imem[L.goff + k] = an[t] >= 0 ? kGPitch * an[t] : -1;
    }
  } else {
    for (int k = tid; k < F * n; k += kThreads) {
      const int a = anc[k];
      imem[L.goff + k] = a >= 0 ? kGPitch * a : -1;
    }
  }
#pragma unroll
  for (int t = 0; t < kLQ; ++t) {
    const int k = tid + t * kThreads;
    if (k < kEnvs * n) {
      smem[L.q + k] = qv[t];
      smem[L.qd + k] = qdv[t];
    }
  }
#pragma unroll
  for (int t = 0; t < kLAxis; ++t) {
    const int k = tid + t * kThreads;
    if (k < 3 * F) smem[L.axis + k] = axv[t];
  }
  if (tid < F) {
    imem[L.parent + tid] = par;
    imem[L.type + tid] = typ;
    imem[L.qidx + tid] = qix;
  }
  for (int k = tid; k < kEnvs * F; k += kThreads) {
    const int e = k / F, f = k % F;
    imem[L.frame + k] = f;
    imem[L.trow + k] = e * L.tstride + 16 * f;
    imem[L.gbase + k] = e * L.gstride;
  }
  for (int k = tid; k < 4 * n; k += kThreads)
    imem[L.elem + k] = ((4 * k / n) << 8) | (4 * k % n);
  if (tid < 16) {
    smem[L.eye + tid] = (tid % 5 == 0) ? 1.0f : 0.0f;  // identity
    smem[L.eye + 16 + tid] = 0.0f;                      // zero
  }
  __syncthreads();

  // ---- per frame, once: the joint generators (per model) and the joint
  // motions (per env), transposed so the recursion reads columns as float4
  for (int k = tid; k < (kEnvs + 1) * F; k += kThreads) {
    const int e = k / F, f = k % F;  // e == kEnvs: the model's generator
    const int jt = imem[L.type + f];
    const float ax = smem[L.axis + 3 * f], ay = smem[L.axis + 3 * f + 1],
                az = smem[L.axis + 3 * f + 2];
    float m[16];
    if (e == kEnvs) {
      rmp::joint_generator(m, jt, ax, ay, az);
      rmp::store_transposed(smem + L.Et + 16 * f, m);
    } else {
      const int qi = imem[L.qidx + f];
      rmp::joint_motion(m, jt, ax, ay, az,
                   jt == rmp::kFixed ? 0.0f : smem[L.q + e * n + qi]);
      rmp::store_transposed(smem + L.Tv + e * L.tstride + 16 * f, m);
    }
  }
  __syncthreads();

  // ---- the recursion (fk_common.cuh): env e, entry (i, j) ----
  {
    const int e = tid >> 4;
    const rmp::FkModel model{s_parent, imem + L.type, s_qidx, smem + L.Tc,
                             smem + L.Et, smem + L.eye};
    const rmp::FkArrays arrays{
        smem + L.T + e * L.tstride,  smem + L.Tt + e * L.tstride,
        smem + L.W + e * L.tstride,  smem + L.C + e * L.tstride,
        smem + L.G + e * L.gstride,  smem + L.scratch + e * 48,
        smem + L.Tv + e * L.tstride, smem + L.qd + e * n};
    rmp::fk_recursion(F, tid & 15, model, arrays);
  }
  __syncthreads();

  // ---- the stores, in the outputs' memory order ----
  // (env, frame) rows of the tile: row ef = e F + f
  const int rows = nv * F;
  const size_t row0 = static_cast<size_t>(b0) * F;
  float4* T4 = reinterpret_cast<float4*>(T16 + row0 * 16);
  float4* Td4 = reinterpret_cast<float4*>(Td16 + row0 * 16);
  float4* c4 = reinterpret_cast<float4*>(c16 + row0 * 16);
  for (int v = tid; v < rows * 4; v += kThreads) {
    const int o = s_trow[v >> 2] + 4 * (v & 3);  // row i = v & 3
    const float* Tt = smem + L.Tt + s_trow[v >> 2];
    const float4 t0 = ld4(Tt), t1 = ld4(Tt + 4), t2 = ld4(Tt + 8),
                 t3 = ld4(Tt + 12);
    const float4 w = ld4(smem + L.W + o);
    const float4 cc = ld4(smem + L.C + o);
    T4[v] = ld4(smem + L.T + o);
    Td4[v] = make_float4(dot4(w, t0), dot4(w, t1), dot4(w, t2), dot4(w, t3));
    c4[v] = make_float4(dot4(cc, t0), dot4(cc, t1), dot4(cc, t2),
                        dot4(cc, t3));
  }

  // J: a row's 16 n floats are 4 n float4, so no float4 crosses rows.
  // Float4 v is (row ef, float4 w of the row); a step of kThreads moves
  // (ef, w) by a constant, so no division runs in the loop.
  const int per_row = 4 * n;
  const int step_rows = kThreads / per_row, step_w = kThreads % per_row;
  float4* J4 = reinterpret_cast<float4*>(J16 + row0 * 16 * n);
  int ef = tid / per_row, w = tid % per_row;
  for (int v = tid; v < rows * per_row; v += kThreads) {
    const int* goff = s_goff + s_frame[ef] * n;
    int rr = s_elem[w] >> 8, m = s_elem[w] & 255;
    // the env's generators; T_f's column rr % 4, reloaded when rr moves on
    const float* Ge = smem + L.G + s_gbase[ef];
    const float* Tt = smem + L.Tt + s_trow[ef];
    float4 col = ld4(Tt + 4 * (rr & 3));
    float out[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int o = goff[m];
      out[k] = o >= 0 ? dot4(ld4(Ge + o + 4 * (rr >> 2)), col) : 0.0f;
      if (++m == n) {
        m = 0;
        ++rr;
        col = ld4(Tt + 4 * (rr & 3));
      }
    }
    J4[v] = make_float4(out[0], out[1], out[2], out[3]);
    ef += step_rows;
    w += step_w;
    if (w >= per_row) {
      w -= per_row;
      ++ef;
    }
  }
}

template <int kMaxFrames, int kMaxMotors, int kEnvs>
int launch(int B, int F, int n, const int* parent, const int* joint_type,
           const int* q_index, const float* axis, const float* T_constant,
           const int* anc, const float* q, const float* qd, float* T16,
           float* Td16, float* J16, float* c16, cudaStream_t stream) {
  auto kernel = fk_derivatives_kernel<kMaxFrames, kMaxMotors, kEnvs>;
  const int bytes = Layout<kEnvs>(F, n).bytes();
  if (bytes > 48 * 1024) {  // above the default: opt in (up to 227 KB)
    const cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  kernel<<<cdiv(B, kEnvs), 16 * kEnvs, bytes, stream>>>(
      B, F, n, parent, joint_type, q_index, axis, T_constant, anc, q, qd,
      T16, Td16, J16, c16);
  return static_cast<int>(cudaGetLastError());
}

// Index into kTiles of the instantiation that serves (F, n), or -1.
int tile_of(int F, int n) {
  for (int t = 0; t < static_cast<int>(sizeof(kTiles) / sizeof(Tile)); ++t)
    if (F <= kTiles[t].frames && n <= kTiles[t].motors) return t;
  return -1;
}

}  // namespace

// Dynamic shared memory of one CTA for a model of F frames and n motors
// (-1: no instantiation takes the model).
extern "C" int rmp_fk_derivatives_shared_bytes(int F, int n) {
  switch (tile_of(F, n)) {
    case 0:
      return Layout<kTiles[0].envs>(F, n).bytes();
    case 1:
      return rmp_k3::wide_shared_bytes(F, n);
    case 2:
      return rmp_k3::xl_shared_bytes(F, n);
    default:
      return -1;
  }
}

// Envs that one SM holds at once for a model of F frames and n motors, by
// the occupancy calculator on the current device (-1: no instantiation
// takes the model, or a CUDA error).
extern "C" int rmp_fk_derivatives_envs_per_sm(int F, int n) {
  switch (tile_of(F, n)) {
    case 0: {
      auto kernel = fk_derivatives_kernel<kTiles[0].frames,
                                          kTiles[0].motors, kTiles[0].envs>;
      const int bytes = Layout<kTiles[0].envs>(F, n).bytes();
      int ctas = 0;
      if (cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes) != cudaSuccess ||
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &ctas, kernel, 16 * kTiles[0].envs, bytes) != cudaSuccess)
        return -1;
      return ctas * kTiles[0].envs;
    }
    case 1:
      return rmp_k3::wide_envs_per_sm(F, n);
    case 2:
      return rmp_k3::xl_envs_per_sm(F, n);
    default:
      return -1;
  }
}

// Envs per CTA of the instantiation that serves (F, n) (-1: none).
extern "C" int rmp_fk_derivatives_tile_envs(int F, int n) {
  const int t = tile_of(F, n);
  return t < 0 ? -1 : kTiles[t].envs;
}

// Launches on `stream` of GPU `device` (the caller's current device is
// restored). Returns cudaGetLastError() after the launch, or -1 when the
// model exceeds every instantiation's frame/motor capacity (nothing is
// launched then).
extern "C" int rmp_fk_derivatives_f32(
    int device, int B, int F, int n, const int* parent, const int* joint_type,
    const int* q_index, const float* axis, const float* T_constant,
    const int* anc, const float* q, const float* qd, float* T16, float* Td16,
    float* J16, float* c16, void* stream) {
  const int t = tile_of(F, n);
  if (t < 0) return -1;
  if (B <= 0) return 0;
  int previous = device;
  cudaGetDevice(&previous);
  if (previous != device) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc =
      t == 0 ? launch<kTiles[0].frames, kTiles[0].motors, kTiles[0].envs>(
                   B, F, n, parent, joint_type, q_index, axis, T_constant,
                   anc, q, qd, T16, Td16, J16, c16, s)
      : t == 1 ? rmp_k3::launch_wide(B, F, n, parent, joint_type, q_index,
                                     axis, T_constant, anc, q, qd, T16, Td16,
                                     J16, c16, s)
               : rmp_k3::launch_xl(B, F, n, parent, joint_type, q_index, axis,
                                   T_constant, anc, q, qd, T16, Td16, J16,
                                   c16, s);
  if (previous != device) cudaSetDevice(previous);
  return rc;
}
