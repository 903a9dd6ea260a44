// K4: batched link-hull vs capsule / flat-capped cylinder closest points by
// branchless GJK, one thread per (environment, link, obstacle slot).
//
// Replaces the TPU kernel rmp_tpu/ops/pallas_gjk.py::gjk_hull_obstacles
// (_gjk_hull_obstacles, _kernel, _johnson_lanes). Per pair it runs:
//   * the initial simplex: four copies of the support pair in direction d0
//     (link support at -d0, obstacle support at d0);
//   * `iters` iterations: Johnson on the subsets holding slot 0, the new
//     support pair, the gap test gap <= 1e-5 |x|^2 + 1e-12 that freezes a
//     pair for good, and the eviction of the FIRST minimum-weight slot (the
//     old slot 0 moves into it, the new support takes slot 0) for live pairs;
//   * a full Johnson solve, witnesses pa = sum lam_i Ya_i, pb likewise, and
//     dist = |x|.
// The link support is the TPU kernel's mask average: the mean of every
// vertex whose dot with the link-local direction equals the maximum, here in
// one pass over the vertices in index order as a running (max, count, sum),
// then times 1 / count. Obstacle supports normalise as v / (|v| + 1e-12).
// Plain version: ops/cuda_gjk.gjk_hull_obstacles_plain.
//
// Bound on an H100 SXM: operations. At the flagship (10 links x 3 slots x
// 4096 envs, 96 vertices) one iteration is ~1.5 kFLOP per pair, ~900 of them
// the hull support, so a 4-iteration query is ~0.8 GFLOP (~12 us at
// 67 TFLOP/s fp32) while its operands are ~12 MB (~4 us at 3.35 TB/s).
// Design: a block is 128 envs of one (link, slot); the link's vertex table
// sits in shared memory as float4 rows, so every thread of a warp reads the
// same row (a broadcast) in the support loop. Per-pair operands come
// batch-minor, so neighbouring threads read neighbouring addresses. The
// simplex (2 x 4 slots) and Johnson's algebra stay in registers.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxVerts = 2048;  // 32 KB of float4 rows: below the 48 KB default
constexpr float kEps = 1e-12f;
constexpr float kFeas = -1e-6f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return v3(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V3 scale(float s, V3 a) {
  return v3(s * a.x, s * a.y, s * a.z);
}
__device__ __forceinline__ V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) {
  return v3(c ? a.x : b.x, c ? a.y : b.y, c ? a.z : b.z);
}

// Running best candidate of the Johnson enumeration: a candidate replaces it
// only if feasible and of STRICTLY smaller norm (the first best stays).
struct Best {
  float n2;
  V3 x;
  float lam[4];
};

__device__ __forceinline__ void consider(Best& b, bool feas, V3 x,
                                         const float lam[4]) {
  const float n2 = dot(x, x);
  const bool take = feas && (n2 < b.n2);
  b.n2 = take ? n2 : b.n2;
  b.x = sel(take, x, b.x);
#pragma unroll
  for (int i = 0; i < 4; ++i) b.lam[i] = take ? lam[i] : b.lam[i];
}

template <int I>
__device__ __forceinline__ void single(Best& b, const V3 y[4]) {
  float lam[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  lam[I] = 1.0f;
  consider(b, true, y[I], lam);
}

template <int I, int J>
__device__ __forceinline__ void pair(Best& b, const V3 y[4],
                                     const float d[4][4]) {
  const float e2 = d[I][I] - 2.0f * d[I][J] + d[J][J];
  const float t = (d[I][I] - d[I][J]) / (e2 + kEps);
  const bool feas = (e2 > 1e-12f) && (t >= kFeas) && (t <= 1.0f - kFeas);
  const V3 x = add(y[I], scale(t, sub(y[J], y[I])));
  float lam[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  lam[I] = 1.0f - t;
  lam[J] = t;
  consider(b, feas, x, lam);
}

template <int I, int J, int K>
__device__ __forceinline__ void triple(Best& b, const V3 y[4],
                                       const float d[4][4]) {
  const float a11 = d[J][J] - 2.0f * d[I][J] + d[I][I];
  const float a22 = d[K][K] - 2.0f * d[I][K] + d[I][I];
  const float a12 = d[J][K] - d[I][J] - d[I][K] + d[I][I];
  const float b1 = d[I][J] - d[I][I];
  const float b2 = d[I][K] - d[I][I];
  const float det = a11 * a22 - a12 * a12;
  const bool ok = fabsf(det) > 1e-6f * a11 * a22 + 1e-20f;
  const float inv = 1.0f / (ok ? det : 1.0f);
  const float u = (-b1 * a22 + b2 * a12) * inv;
  const float v = (-a11 * b2 + a12 * b1) * inv;
  const bool feas = ok && (u >= kFeas) && (v >= kFeas) && (1.0f - u - v >= kFeas);
  const V3 x = add(y[I], add(scale(u, sub(y[J], y[I])), scale(v, sub(y[K], y[I]))));
  float lam[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  lam[I] = 1.0f - u - v;
  lam[J] = u;
  lam[K] = v;
  consider(b, feas, x, lam);
}

__device__ __forceinline__ void tetrahedron(Best& b, const V3 y[4]) {
  const V3 e[3] = {sub(y[1], y[0]), sub(y[2], y[0]), sub(y[3], y[0])};
  float g[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) g[r][c] = dot(e[r], e[c]);
  float bb[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) bb[r] = -dot(e[r], y[0]);
  const float c00 = g[1][1] * g[2][2] - g[1][2] * g[2][1];
  const float c01 = g[1][2] * g[2][0] - g[1][0] * g[2][2];
  const float c02 = g[1][0] * g[2][1] - g[1][1] * g[2][0];
  const float det = g[0][0] * c00 + g[0][1] * c01 + g[0][2] * c02;
  const float scl = g[0][0] * g[1][1] * g[2][2];
  const bool ok = fabsf(det) > 1e-6f * scl + 1e-30f;
  const float inv = 1.0f / (ok ? det : 1.0f);
  const float u = (bb[0] * c00 + bb[1] * (g[0][2] * g[2][1] - g[0][1] * g[2][2]) +
                   bb[2] * (g[0][1] * g[1][2] - g[0][2] * g[1][1])) * inv;
  const float v = (bb[0] * c01 + bb[1] * (g[0][0] * g[2][2] - g[0][2] * g[2][0]) +
                   bb[2] * (g[0][2] * g[1][0] - g[0][0] * g[1][2])) * inv;
  const float w = (bb[0] * c02 + bb[1] * (g[0][1] * g[2][0] - g[0][0] * g[2][1]) +
                   bb[2] * (g[0][0] * g[1][1] - g[0][1] * g[1][0])) * inv;
  const bool feas = ok && (u >= kFeas) && (v >= kFeas) && (w >= kFeas) &&
                    (1.0f - u - v - w >= kFeas);
  const float lam[4] = {1.0f - u - v - w, u, v, w};
  consider(b, feas, v3(0.0f, 0.0f, 0.0f), lam);
}

// Closest point of conv(y) to the origin and its barycentric weights, in the
// enumeration order of ops/gjk.johnson (singles, pairs, triples, the whole
// tetrahedron). kNewestOnly: only the subsets holding slot 0.
template <bool kNewestOnly>
__device__ __forceinline__ void johnson(const V3 y[4], V3& x, float lam[4]) {
  float d[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = i; j < 4; ++j) {
      d[i][j] = dot(y[i], y[j]);
      d[j][i] = d[i][j];
    }
  Best b;
  b.n2 = INFINITY;
  b.x = v3(0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < 4; ++i) b.lam[i] = 0.0f;
  single<0>(b, y);
  if (!kNewestOnly) {
    single<1>(b, y);
    single<2>(b, y);
    single<3>(b, y);
  }
  pair<0, 1>(b, y, d);
  pair<0, 2>(b, y, d);
  pair<0, 3>(b, y, d);
  if (!kNewestOnly) {
    pair<1, 2>(b, y, d);
    pair<1, 3>(b, y, d);
    pair<2, 3>(b, y, d);
  }
  triple<0, 1, 2>(b, y, d);
  triple<0, 1, 3>(b, y, d);
  triple<0, 2, 3>(b, y, d);
  if (!kNewestOnly) triple<1, 2, 3>(b, y, d);
  tetrahedron(b, y);
  x = b.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) lam[i] = b.lam[i];
}

// World support of the posed link hull in world direction d: R s_loc + t,
// with s_loc the mask average over the maximisers of v . (R^T d).
__device__ __forceinline__ V3 support_link(const float4* __restrict__ sv, int V,
                                           const float R[3][3], V3 t, V3 d) {
  const float dl0 = R[0][0] * d.x + R[1][0] * d.y + R[2][0] * d.z;
  const float dl1 = R[0][1] * d.x + R[1][1] * d.y + R[2][1] * d.z;
  const float dl2 = R[0][2] * d.x + R[1][2] * d.y + R[2][2] * d.z;
  float m = -INFINITY, cnt = 0.0f, sx = 0.0f, sy = 0.0f, sz = 0.0f;
  for (int i = 0; i < V; ++i) {
    const float4 p = sv[i];
    const float s = p.x * dl0 + p.y * dl1 + p.z * dl2;
    const bool more = s > m;
    const bool tie = s == m;
    m = more ? s : m;
    cnt = more ? 1.0f : (tie ? cnt + 1.0f : cnt);
    sx = more ? p.x : (tie ? sx + p.x : sx);
    sy = more ? p.y : (tie ? sy + p.y : sy);
    sz = more ? p.z : (tie ? sz + p.z : sz);
  }
  const float inv = 1.0f / cnt;
  const float l0 = sx * inv, l1 = sy * inv, l2 = sz * inv;
  return v3(R[0][0] * l0 + R[0][1] * l1 + R[0][2] * l2 + t.x,
            R[1][0] * l0 + R[1][1] * l1 + R[1][2] * l2 + t.y,
            R[2][0] * l0 + R[2][1] * l1 + R[2][2] * l2 + t.z);
}

// Capsule (segment + ball) or, where cyl, flat-capped cylinder support.
__device__ __forceinline__ V3 support_obstacle(V3 p0, V3 p1, V3 an, float r,
                                               bool cyl, V3 d) {
  const float inv_dn = 1.0f / (sqrtf(dot(d, d)) + kEps);
  const V3 end = sel(dot(d, sub(p1, p0)) > 0.0f, p1, p0);
  const V3 cap = add(end, scale(r * inv_dn, d));
  const float d_ax = dot(d, an);
  const V3 d_perp = sub(d, scale(d_ax, an));
  const float inv_p = 1.0f / (sqrtf(dot(d_perp, d_perp)) + kEps);
  const V3 end_c = sel(d_ax > 0.0f, p1, p0);
  const V3 cyl_pt = add(end_c, scale(r, scale(inv_p, d_perp)));
  return sel(cyl, cyl_pt, cap);
}

__global__ void __launch_bounds__(kThreads) gjk_hull_kernel(
    int M, int V, int B, int iters, const float* __restrict__ verts,
    const float* __restrict__ Rg, const float* __restrict__ tg,
    const float* __restrict__ p0g, const float* __restrict__ p1g,
    const float* __restrict__ ang, const float* __restrict__ radius,
    const float* __restrict__ is_cyl, const float* __restrict__ d0g,
    float* __restrict__ pa_out, float* __restrict__ pb_out,
    float* __restrict__ dist_out) {
  extern __shared__ float4 sv[];
  const int lm = blockIdx.y;  // link * M + slot
  const int l = lm / M;
  for (int i = threadIdx.x; i < V; i += blockDim.x) {
    const float* v = verts + (static_cast<size_t>(l) * V + i) * 3;
    sv[i] = make_float4(v[0], v[1], v[2], 0.0f);
  }
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);

  float R[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) R[r][c] = Rg[(static_cast<size_t>(l) * 9 + r * 3 + c) * sB + b];
  const float* tl = tg + static_cast<size_t>(l) * 3 * sB + b;
  const V3 t = v3(tl[0], tl[sB], tl[2 * sB]);
  const size_t pair_off = static_cast<size_t>(lm) * 3 * sB + b;
  auto load3 = [&](const float* g) {
    return v3(g[pair_off], g[pair_off + sB], g[pair_off + 2 * sB]);
  };
  const V3 p0 = load3(p0g), p1 = load3(p1g), an = load3(ang), d0 = load3(d0g);
  const float r = radius[static_cast<size_t>(lm) * sB + b];
  const bool cyl = is_cyl[static_cast<size_t>(lm) * sB + b] > 0.5f;

  const V3 sa0 = support_link(sv, V, R, t, neg(d0));
  const V3 sb0 = support_obstacle(p0, p1, an, r, cyl, d0);
  V3 Ya[4] = {sa0, sa0, sa0, sa0};
  V3 Yb[4] = {sb0, sb0, sb0, sb0};
  bool done = false;

  for (int it = 0; it < iters; ++it) {
    V3 Yd[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) Yd[i] = sub(Ya[i], Yb[i]);
    V3 x;
    float lam[4];
    johnson<true>(Yd, x, lam);
    const V3 sa = support_link(sv, V, R, t, neg(x));
    const V3 sb = support_obstacle(p0, p1, an, r, cyl, x);
    const float n2 = dot(x, x);
    const float gap = n2 - dot(x, sub(sa, sb));
    done = done || (gap <= 1e-5f * n2 + 1e-12f);
    // evict the first minimum-weight slot, rotate the old slot 0 into it,
    // insert the new support at slot 0 (live pairs only)
    const float m = fminf(fminf(lam[0], lam[1]), fminf(lam[2], lam[3]));
    const bool live = !done;
    bool taken = false;
    const V3 old_a = Ya[0], old_b = Yb[0];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool e = (lam[i] <= m) && !taken;
      taken = taken || e;
      Ya[i] = sel(e && live, old_a, Ya[i]);
      Yb[i] = sel(e && live, old_b, Yb[i]);
    }
    Ya[0] = sel(live, sa, Ya[0]);
    Yb[0] = sel(live, sb, Yb[0]);
  }

  V3 Yd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) Yd[i] = sub(Ya[i], Yb[i]);
  V3 x;
  float lam[4];
  johnson<false>(Yd, x, lam);
  V3 pa = v3(0.0f, 0.0f, 0.0f), pb = v3(0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    pa = add(pa, scale(lam[i], Ya[i]));
    pb = add(pb, scale(lam[i], Yb[i]));
  }
  pa_out[pair_off] = pa.x;
  pa_out[pair_off + sB] = pa.y;
  pa_out[pair_off + 2 * sB] = pa.z;
  pb_out[pair_off] = pb.x;
  pb_out[pair_off + sB] = pb.y;
  pb_out[pair_off + 2 * sB] = pb.z;
  dist_out[static_cast<size_t>(lm) * sB + b] = sqrtf(dot(x, x));
}

}  // namespace

// Layouts (batch-minor, contiguous): verts (L, V, 3); R (L, 3, 3, B);
// t (L, 3, B); p0, p1, an, d0 (L, M, 3, B); radius, is_cyl (L, M, B).
// Outputs pa, pb (L, M, 3, B), dist (L, M, B). Launches on `stream` of GPU
// `device`. Returns cudaGetLastError() after the launch, or -1 when V is
// outside [1, 2048] (nothing is launched then).
extern "C" int rmp_gjk_hull_f32(int device, int L, int M, int V, int B,
                                int iters, const float* verts, const float* R,
                                const float* t, const float* p0,
                                const float* p1, const float* an,
                                const float* radius, const float* is_cyl,
                                const float* d0, float* pa, float* pb,
                                float* dist, void* stream) {
  if (V < 1 || V > kMaxVerts) return -1;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (B > 0 && L > 0 && M > 0) {
    const dim3 grid((B + kThreads - 1) / kThreads, L * M);
    const size_t shmem = static_cast<size_t>(V) * sizeof(float4);
    gjk_hull_kernel<<<grid, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(
        M, V, B, iters, verts, R, t, p0, p1, an, radius, is_cyl, d0, pa, pb, dist);
  }
  return static_cast<int>(cudaGetLastError());
}
