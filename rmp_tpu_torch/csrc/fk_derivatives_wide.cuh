// K3's wide kernel: batched closed-form FK derivatives for models past the
// narrow tile (fk_derivatives.cu), up to 40 frames and 32 motors: the
// N-link arms (F = 25, n = 24; F = 33, n = 32) and any tree of that size;
// instantiated again at 72 frames and 64 motors (fk_derivatives_xl.cu) for
// the models past that: four Pandas (F = 52, n = 36), the 64-link arm.
//
// Replaces the TPU kernel rmp_tpu/ops/pallas_fk.py::fk_derivatives_batched
// (_build / _make_kernel) for those models; fk_derivatives.cu's head note
// says what K3 computes. Plain version: models/fk_derivatives.py.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. At F = 33, n = 32 an env writes
// 33 x 16 x 35 floats (J alone 33 x 16 x 32), 303.8 MB at B = 4096:
// 90.7 us; at F = 25, n = 24, 177.7 MB, 53.1 us. Its 4x4 products take a
// few us at the fp32 peak. So the kernel's job is to keep the stores
// flowing at the memory rate, from enough envs on each SM at once.
//
// Design.
// - A half warp runs an env's recursion (fk_common.cuh's closed form,
//   written out here per frame), lane r = 4 i + j owning entry (i, j) of
//   every 4x4 product; __syncwarp orders the half warp. kEnvs envs a CTA.
// - Each frame's outputs are final once its step is done (frames are in
//   topological order: a step reads only its parent's T, W, Wd and its
//   ancestors' generators G, all of earlier frames). So the half warp
//   stores frame f's rows of T, Td, c and J right after its step, while
//   the SM's other warps run their steps: the stores overlap the
//   recursion, and no pass over the whole tile follows it.
// - J's row of (env, f), 16 rows of n motors, is made by motor lanes:
//   lane r takes motors r + 16 k (k < kMaxMotors / 16: r and r + 16 up to
//   32 motors) and reads row gi of G[anc[f][m]] (a
//   float4; non-ancestors read a zero matrix, so no lane diverges on anc)
//   for the four entries J[4 gi + jj][m], a quarter of a shared load per
//   output (four in the narrow kernel's store pass). Four rows at a time
//   (4 n floats) are staged in shared memory and copied out by the half
//   warp as 16-byte float4s in memory order: a store is 256 contiguous
//   bytes, whole 32-byte sectors for any n (a motor lane's own stores, n
//   floats apart, straddle sectors unless 8 divides n, and ran at half the
//   rate).
// - Shared memory holds per env only what the recursion reads: T, W, Wd
//   and G, each as rows 0-2 of a frame's 4x4 (12 floats; G's rows of 8
//   generators 12 floats apart hit 8 bank groups), and the current frame's
//   A, A E, A^-1 and Wd + W W as whole 4x4s, over which J's rows are
//   staged once they are dead: 48 F + max(64, 4 n) + 32 floats, 6.8 KB at
//   F = 33, n = 32 (13.2 KB in the narrow kernel's layout). So 32 envs fit
//   on an SM there (and the registers, 114 a thread, hold as many): 4096
//   envs are one wave, and no SM waits on a part-filled last one (the
//   launch, fk_derivatives_wide.cu, makes the waves whole where they are
//   more). Row 3 is (0, 0, 0, 1) in T and zero in W, Wd, G, C and so in
//   Td, c and J, exactly, in the plain version too: the kernel writes
//   those constants and computes the other rows as before.
// - The model's tables are read through the read-only cache, a frame
//   ahead; each lane makes only its own column of the joint motion and of
//   the generator. q, qd, sin q and cos q are made once, motors r + 16 k on
//   lane r, and reach a frame's step by __shfl_sync.
// - Every sum is taken in the order of the narrow kernel (dot4: a.x b.x
//   first), so both kernels give the same values up to the compiler's
//   contractions.
#pragma once

#include <cuda_runtime.h>

#include "fk_common.cuh"

namespace rmp_k3 {

using rmp::col4;
using rmp::dot4;
using rmp::ld4;

// The wide kernel's capacity and tile: fk_derivatives.cu's kTiles[1]
constexpr int kWideFrames = 40;
constexpr int kWideMotors = 32;
constexpr int kWideEnvs = 4;
// Its second instantiation (fk_derivatives_xl.cu), kTiles[2]: at (72, 64)
// an env holds 3,760 floats (15.0 KB) of shared memory, so a CTA of 2 envs
// lets an SM hold 14 of them, 4 envs a CTA 12.
constexpr int kXlFrames = 72;
constexpr int kXlMotors = 64;
constexpr int kXlEnvs = 2;

// Floats of a frame's T, W, Wd and G in shared memory: rows 0-2.
constexpr int kRows3 = 12;

// Float offsets within an env's block of shared memory; envs lie `stride`
// floats apart, 16 mod 32, so the two envs of a warp read the same entry
// from opposite halves of the banks. Four rows of the current frame's J
// (Js, 4 n floats) are staged at a time over its A, A E, A^-1 and C (4x4
// each), which are dead by then.
struct WideLayout {
  int T, W, D, G, A, AE, Ainv, C, Js, eye, zero, stride;
  __host__ __device__ constexpr WideLayout(int F, int n)
      : T(0), W(kRows3 * F), D(2 * kRows3 * F), G(3 * kRows3 * F),
        A(4 * kRows3 * F), AE(A + 16), Ainv(A + 32), C(A + 48), Js(A),
        eye(A + (4 * n > 64 ? 4 * n : 64)), zero(eye + 16),
        stride(rmp::odd_half(zero + 16)) {}
  __host__ __device__ constexpr int bytes(int envs) const {
    return 4 * envs * stride;
  }
};

// Column j of the joint motion Tv: fk_common.cuh's joint_motion, entry
// for entry, from the joint's q and its sine and cosine.
__device__ __forceinline__ float4 motion_col(int jt, float ax, float ay,
                                             float az, float qv, float s,
                                             float c, int j) {
  float4 e = make_float4(j == 0 ? 1.0f : 0.0f, j == 1 ? 1.0f : 0.0f,
                         j == 2 ? 1.0f : 0.0f, j == 3 ? 1.0f : 0.0f);
  if (jt == rmp::kRevolute) {
    if (j < 3 && ax * ax + ay * ay + az * az > 0.5f) {
      const float oc = 1.0f - c;
      const float aj = j == 0 ? ax : j == 1 ? ay : az;
      e.x = (j == 0 ? c : j == 1 ? -s * az : s * ay) + oc * (ax * aj);
      e.y = (j == 0 ? s * az : j == 1 ? c : -s * ax) + oc * (ay * aj);
      e.z = (j == 0 ? -s * ay : j == 1 ? s * ax : c) + oc * (az * aj);
    }
  } else if (jt == rmp::kPrismatic && j == 3) {
    e = make_float4(qv * ax, qv * ay, qv * az, 1.0f);
  }
  return e;
}

// Column j of an actuated joint's generator E (fk_common.cuh's
// joint_generator).
__device__ __forceinline__ float4 generator_col(int jt, float ax, float ay,
                                                float az, int j) {
  if (jt == rmp::kPrismatic)
    return j == 3 ? make_float4(ax, ay, az, 0.0f)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  return make_float4(j == 1 ? -az : j == 2 ? ay : 0.0f,
                     j == 0 ? az : j == 2 ? -ax : 0.0f,
                     j == 0 ? -ay : j == 1 ? ax : 0.0f, 0.0f);
}

// A frame's model entries, read a frame ahead of its step.
struct FrameTables {
  int parent, type, qidx, anc0, anc1;
  float ax, ay, az;
  float4 tc;  // column j of the constant transform
};

__device__ __forceinline__ FrameTables frame_tables(
    int f, int n, int r, const int* __restrict__ parent,
    const int* __restrict__ joint_type, const int* __restrict__ q_index,
    const float* __restrict__ axis, const float* __restrict__ T_constant,
    const int* __restrict__ anc) {
  const int j = r & 3;
  const float* tc = T_constant + 16 * f + j;
  FrameTables t;
  t.parent = __ldg(parent + f);
  t.type = __ldg(joint_type + f);
  t.qidx = __ldg(q_index + f);
  t.anc0 = r < n ? __ldg(anc + f * n + r) : -1;
  t.anc1 = r + 16 < n ? __ldg(anc + f * n + r + 16) : -1;
  t.ax = __ldg(axis + 3 * f);
  t.ay = __ldg(axis + 3 * f + 1);
  t.az = __ldg(axis + 3 * f + 2);
  t.tc = make_float4(__ldg(tc), __ldg(tc + 4), __ldg(tc + 8), __ldg(tc + 12));
  return t;
}

// Column j of a frame's 4x4 kept as rows 0-2, with `last` as row 3.
__device__ __forceinline__ float4 col3(const float* m, int j, float last) {
  return make_float4(m[j], m[4 + j], m[8 + j], last);
}

// Ancestors of a frame for motors r + 16 k, k = 2 .. kMore + 1, of lane r
// (-1: none): the motors past r and r + 16 of the (72, 64) tile.
template <int kMore>
__device__ __forceinline__ void more_ancestors(int (&out)[kMore], int f,
                                               int n, int r,
                                               const int* __restrict__ anc) {
#pragma unroll
  for (int k = 0; k < kMore; ++k) {
    const int m = r + 16 * (k + 2);
    out[k] = m < n ? __ldg(anc + f * n + m) : -1;
  }
}

// J[4 gi + jj][m], jj = 0-3, of frame f for the lane's motor m, from row
// gi of G[anc[f][m]] and T_f's columns c0..c3: 4 floats, n apart.
__device__ __forceinline__ void stage_j_rows(float* __restrict__ out, int n,
                                             float4 g, float4 c0, float4 c1,
                                             float4 c2, float4 c3) {
  out[0] = dot4(g, c0);
  out[n] = dot4(g, c1);
  out[2 * n] = dot4(g, c2);
  out[3 * n] = dot4(g, c3);
}

template <int kMaxFrames, int kMaxMotors, int kEnvs>
__global__ void __launch_bounds__(16 * kEnvs) fk_derivatives_kernel_wide(
    int B, int F, int n, const int* __restrict__ parent,
    const int* __restrict__ joint_type, const int* __restrict__ q_index,
    const float* __restrict__ axis, const float* __restrict__ T_constant,
    const int* __restrict__ anc, const float* __restrict__ q,
    const float* __restrict__ qd, float* __restrict__ T16,
    float* __restrict__ Td16, float* __restrict__ J16,
    float* __restrict__ c16) {
  // motors r and r + 16 on lane r, and past 32 motors r + 16 k for k = 2 ..
  // kSlots - 1 (kept apart, so that a tile of up to 32 motors compiles as
  // it did before the (72, 64) tile)
  constexpr int kSlots = (kMaxMotors + 15) / 16;
  constexpr int kMore = kSlots > 2 ? kSlots - 2 : 1;
  static_assert(kEnvs % 2 == 0, "whole warps: shuffles take every lane");
  extern __shared__ float4 smem4[];
  const WideLayout L(F, n);
  const int tid = threadIdx.x;
  const int r = tid & 15, i = r >> 2, j = r & 3;
  const bool row3 = i == 3;  // entries (3, j): constants, kept nowhere
  const int ir = row3 ? 0 : i;  // a row that exists, for their loads
  const int half = tid & 16;  // the half warp's first lane in its warp
  const int b = blockIdx.x * kEnvs + (tid >> 4);
  const bool live = b < B;  // a masked env runs on zeros and stores nothing
  float* s = reinterpret_cast<float*>(smem4) + (tid >> 4) * L.stride;
  float* sA = s + L.A;
  float* sAE = s + L.AE;
  float* sAinv = s + L.Ainv;
  float* sC = s + L.C;
  float* sJ = s + L.Js;

  // ---- the env's q, qd (motor r and r + 16 on lane r), the sines and
  // cosines of q, and the constants
  float q0 = 0.0f, q1 = 0.0f, qd0 = 0.0f, qd1 = 0.0f;
  if (live) {
    const size_t o = static_cast<size_t>(b) * n;
    if (r < n) {
      q0 = q[o + r];
      qd0 = qd[o + r];
    }
    if (r + 16 < n) {
      q1 = q[o + r + 16];
      qd1 = qd[o + r + 16];
    }
  }
  float sin0, cos0, sin1, cos1;
  sincosf(q0, &sin0, &cos0);
  sincosf(q1, &sin1, &cos1);
  // motors r + 32, r + 48 (the (72, 64) tile)
  float qm[kMore], qdm[kMore], sinm[kMore], cosm[kMore];
  int ancm_next[kMore];
  if constexpr (kSlots > 2) {
    const size_t o = static_cast<size_t>(live ? b : 0) * n;
#pragma unroll
    for (int k = 0; k < kMore; ++k) {
      const int m = r + 16 * (k + 2);
      qm[k] = live && m < n ? q[o + m] : 0.0f;
      qdm[k] = live && m < n ? qd[o + m] : 0.0f;
      sincosf(qm[k], &sinm[k], &cosm[k]);
    }
    more_ancestors<kMore>(ancm_next, 0, n, r, anc);
  }
  s[L.eye + r] = (r % 5 == 0) ? 1.0f : 0.0f;
  s[L.zero + r] = 0.0f;
  const size_t row0 = static_cast<size_t>(live ? b : 0) * F;
  float* oT = T16 + row0 * 16;
  float* oTd = Td16 + row0 * 16;
  float* oc = c16 + row0 * 16;
  float* oJ = J16 + row0 * 16 * n;
  FrameTables next = frame_tables(0, n, r, parent, joint_type, q_index,
                                  axis, T_constant, anc);
  __syncwarp();

  // ---- the frames, in topological order ----
  for (int f = 0; f < F; ++f) {
    const FrameTables tab = next;
    int ancm[kMore];
    if constexpr (kSlots > 2) {
#pragma unroll
      for (int k = 0; k < kMore; ++k) ancm[k] = ancm_next[k];
      if (f + 1 < F) more_ancestors<kMore>(ancm_next, f + 1, n, r, anc);
    }
    if (f + 1 < F)
      next = frame_tables(f + 1, n, r, parent, joint_type, q_index, axis,
                          T_constant, anc);
    const int p = tab.parent, jt = tab.type;
    const int qs = tab.qidx < 0 ? 0 : tab.qidx;
    // q, qd, sin q and cos q of the frame's motor, from the lane that
    // holds them (every lane runs the shuffles: qs is the same on all)
    const int src = half + (qs & 15);
    const bool lo = qs < 16;
    float qo = lo ? q0 : q1, qdo = lo ? qd0 : qd1;
    float so = lo ? sin0 : sin1, co = lo ? cos0 : cos1;
    if constexpr (kSlots > 2) {
#pragma unroll
      for (int k = 0; k < kMore; ++k) {
        if (qs >= 16 * (k + 2)) {
          qo = qm[k];
          qdo = qdm[k];
          so = sinm[k];
          co = cosm[k];
        }
      }
    }
    const float qv = __shfl_sync(0xffffffffu, qo, src);
    const float qdv = __shfl_sync(0xffffffffu, qdo, src);
    const float sv = __shfl_sync(0xffffffffu, so, src);
    const float cv = __shfl_sync(0xffffffffu, co, src);
    const float* Tp = p < 0 ? s + L.eye : s + L.T + kRows3 * p;
    const float* Wp = p < 0 ? s + L.zero : s + L.W + kRows3 * p;
    const float* Dp = p < 0 ? s + L.zero : s + L.D + kRows3 * p;
    float* Tf = s + L.T + kRows3 * f;
    float* Gf = s + L.G + kRows3 * f;
    const int rr = row3 ? 0 : r;  // this lane's entry of a stored frame
    float t = 0.0f, d = 0.0f;
    {  // ---- the step of frame f: T, G, W, Wd ----
      sA[r] = dot4(row3 ? make_float4(0.0f, 0.0f, 0.0f, 1.0f)
                        : ld4(Tp + 4 * i),
                   tab.tc);
      __syncwarp();
      const float4 arow = ld4(sA + 4 * i);
      t = dot4(arow, motion_col(jt, tab.ax, tab.ay, tab.az, qv, sv, cv,
                                j));  // A Tv
      if (!row3) Tf[r] = t;
      float w;
      if (jt == rmp::kFixed) {
        w = Wp[rr];
        d = Dp[rr];
      } else {
        sAE[r] = dot4(arow, generator_col(jt, tab.ax, tab.ay, tab.az,
                                          j));  // A E
        // entry (i, j) of the rigid inverse of A, without branches
        const float rot = sA[4 * j + i];
        const float trans = -(sA[i] * sA[3] + sA[4 + i] * sA[7] +
                              sA[8 + i] * sA[11]);
        sAinv[r] = i == 3 ? (j == 3 ? 1.0f : 0.0f) : (j < 3 ? rot : trans);
        __syncwarp();
        const float g = dot4(ld4(sAE + 4 * i), col4(sAinv, j));
        if (!row3) Gf[r] = g;
        __syncwarp();
        const float wg = dot4(ld4(Wp + 4 * ir), col3(Gf, j, 0.0f));
        const float gw = dot4(ld4(Gf + 4 * ir), col3(Wp, j, 0.0f));
        w = Wp[rr] + qdv * g;
        d = Dp[rr] + qdv * (wg - gw);
      }
      if (!row3) {
        s[L.W + kRows3 * f + r] = w;
        s[L.D + kRows3 * f + r] = d;
      }
      __syncwarp();
    }
    // ---- frame f's rows of T, Td and c ----
    const float* Wf = s + L.W + kRows3 * f;
    const float4 wrow = ld4(Wf + 4 * ir);
    const float4 tcol = col3(Tf, j, j == 3 ? 1.0f : 0.0f);
    sC[r] = dot4(wrow, col3(Wf, j, 0.0f)) + d;  // Wd + W W
    const float td = dot4(wrow, tcol);
    __syncwarp();
    const float cc = dot4(ld4(sC + 4 * ir), tcol);
    if (live) {
      oT[16 * f + r] = t;  // row 3: A's (0, 0, 0, 1) times Tv, exact
      oTd[16 * f + r] = row3 ? 0.0f : td;
      oc[16 * f + r] = row3 ? 0.0f : cc;
    }
    __syncwarp();  // the J row is staged over sC
    // ---- frame f's row of J: motors r + 16 k ----
    {
      const float4 t0 = ld4(Tf), t1 = ld4(Tf + 4), t2 = ld4(Tf + 8);
      const float4 c0 = make_float4(t0.x, t1.x, t2.x, 0.0f);
      const float4 c1 = make_float4(t0.y, t1.y, t2.y, 0.0f);
      const float4 c2 = make_float4(t0.z, t1.z, t2.z, 0.0f);
      const float4 c3 = make_float4(t0.w, t1.w, t2.w, 1.0f);
      const float* G0 =
          tab.anc0 < 0 ? s + L.zero : s + L.G + kRows3 * tab.anc0;
      const float* G1 =
          tab.anc1 < 0 ? s + L.zero : s + L.G + kRows3 * tab.anc1;
      const float* Gm[kMore];
      if constexpr (kSlots > 2) {
#pragma unroll
        for (int k = 0; k < kMore; ++k)
          Gm[k] = ancm[k] < 0 ? s + L.zero : s + L.G + kRows3 * ancm[k];
      }
      float4* dst = reinterpret_cast<float4*>(oJ + static_cast<size_t>(f) *
                                                       16 * n);
      // rows 4 gi .. 4 gi + 3 a pass (n float4s of the row): staged by the
      // motor lanes, then out as 16-byte aligned float4s in memory order
#pragma unroll
      for (int gi = 0; gi < 3; ++gi) {
        if (r < n) stage_j_rows(sJ + r, n, ld4(G0 + 4 * gi), c0, c1, c2, c3);
        if (r + 16 < n)
          stage_j_rows(sJ + r + 16, n, ld4(G1 + 4 * gi), c0, c1, c2, c3);
        if constexpr (kSlots > 2) {
#pragma unroll
          for (int k = 0; k < kMore; ++k)
            if (r + 16 * (k + 2) < n)
              stage_j_rows(sJ + r + 16 * (k + 2), n, ld4(Gm[k] + 4 * gi), c0,
                           c1, c2, c3);
        }
        __syncwarp();
        if (live)
          for (int w = r; w < n; w += 16) dst[gi * n + w] = ld4(sJ + 4 * w);
        __syncwarp();
      }
      // rows 12-15: zero
      if (live)
        for (int w = r; w < n; w += 16)
          dst[3 * n + w] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __syncwarp();  // sA, sC, sJ are the next frame's
  }
}

// Declared here, defined in fk_derivatives_wide.cu (the instantiation at
// kWide*) and fk_derivatives_xl.cu (at kXl*), each with its launch
// (fk_wide_launch.cuh): the launch on `stream` (cudaGetLastError() after
// it), the layout's dynamic shared memory a CTA, and the envs an SM holds at
// once at that size (-1 on an error).
int launch_wide(int B, int F, int n, const int* parent, const int* joint_type,
                const int* q_index, const float* axis, const float* T_constant,
                const int* anc, const float* q, const float* qd, float* T16,
                float* Td16, float* J16, float* c16, cudaStream_t stream);
int wide_shared_bytes(int F, int n);
int wide_envs_per_sm(int F, int n);
int launch_xl(int B, int F, int n, const int* parent, const int* joint_type,
              const int* q_index, const float* axis, const float* T_constant,
              const int* anc, const float* q, const float* qd, float* T16,
              float* Td16, float* J16, float* c16, cudaStream_t stream);
int xl_shared_bytes(int F, int n);
int xl_envs_per_sm(int F, int n);

}  // namespace rmp_k3
