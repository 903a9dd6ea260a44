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
// vertex whose dot with the link-local direction equals the maximum. Obstacle
// supports normalise as v / (|v| + 1e-12). Plain version:
// ops/cuda_gjk.gjk_hull_obstacles_plain.
//
// Bound on an H100 SXM: operations, and in practice instruction issue. At
// the flagship (10 links x 3 slots x 4096 envs, 96-vertex tables whose two
// finger links hold 18 distinct rows) a support needs a dot and a max per
// distinct vertex (6 flops), a Johnson step on the newest subsets ~470, and
// a pair needs only the iterations until it freezes; the operands are
// ~12 MB (~4 us at 3.35 TB/s). chip_smoke.k4_bound counts what a call's
// pairs need.
//
// Design.
// - A block is 128 envs of one (link, slot). The link's vertex table sits in
//   shared memory as float4 rows (x, y, z, row index), so a warp reads one
//   row as a broadcast, and so do each thread's pose and obstacle operands
//   (23 floats, [field][thread], conflict-free). The simplex (2 x 4 slots)
//   and Johnson's algebra stay in registers: 92 per thread, 5 blocks per
//   SM, so the flagship's 960 blocks take 1.45 waves. Capped at 64
//   registers (__launch_bounds__(128, 8), one wave) the build spills and
//   measured slower (PERF.md; kernel_probe.py's register_cap_64 variant);
//   with the simplex in shared memory too it still spilled and was no
//   faster. The kernel is issue-bound: ~10 instructions per vertex in the
//   scan, ~700 per iteration outside it.
// - The support scan is one pass over the table's distinct rows that keeps
//   the running max m, the first maximiser and r, the largest of
//   min(m_running, s) over the rows: r == m whenever the max is reached
//   twice, so without a tie the support is the first maximiser itself,
//   bit for bit the mask average of one vertex (x * (1 / 1)). Otherwise a
//   second pass sums the tied rows in index order and divides by their
//   count. The rows are the table's distinct ones: each block counts the
//   trailing copies of row 0 (the loader's padding) once, and the tie pass
//   adds them as one multiple of row 0 where row 0 is a maximiser. Both
//   passes compute a dot with the same explicit roundings, so the second
//   finds exactly the first one's maximisers.
// - A warp leaves the iteration loop once every one of its pairs is frozen
//   (__all_sync): a frozen pair's simplex never changes again, so the
//   outputs are those of running every iteration. On the main path the warm
//   start is the last tick's witness difference and most pairs freeze at
//   the first iteration.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxVerts = 2048;  // 32 KB of float4 rows
constexpr float kEps = 1e-12f;
constexpr float kFeas = -1e-6f;

// A thread's operands in shared memory, field f at ops[f * kThreads + tid]:
// R row-major, t, the obstacle's p0, p1, unit axis, radius and cylinder flag.
enum : int { kR = 0, kT = 9, kP0 = 12, kP1 = 15, kAn = 18, kRad = 21,
             kCyl = 22, kFields = 23 };

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

// Field f of this thread's operands.
__device__ __forceinline__ float op(const float* ops, int f) {
  return ops[f * kThreads];
}
__device__ __forceinline__ V3 op3(const float* ops, int f) {
  return v3(op(ops, f), op(ops, f + 1), op(ops, f + 2));
}
// Row . local direction, with explicit roundings: both scans of
// support_link compute every row's value bit for bit alike.
__device__ __forceinline__ float row_dot(float4 p, float d0, float d1,
                                         float d2) {
  return __fmaf_rn(p.z, d2, __fmaf_rn(p.y, d1, __fmul_rn(p.x, d0)));
}

// World support of the posed link hull in world direction d: R s_loc + t,
// s_loc the mask average over the maximisers of v . (R^T d). sv holds the
// table's n distinct rows; `pad` more rows (not stored) repeat row 0.
__device__ __forceinline__ V3 support_link(const float4* __restrict__ sv,
                                           int n, int pad, const float* ops,
                                           V3 d) {
  const float dl0 = op(ops, kR + 0) * d.x + op(ops, kR + 3) * d.y + op(ops, kR + 6) * d.z;
  const float dl1 = op(ops, kR + 1) * d.x + op(ops, kR + 4) * d.y + op(ops, kR + 7) * d.z;
  const float dl2 = op(ops, kR + 2) * d.x + op(ops, kR + 5) * d.y + op(ops, kR + 8) * d.z;
  float m = -INFINITY, r = -INFINITY, first = 0.0f;
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const float4 p = sv[i];
    const float s = row_dot(p, dl0, dl1, dl2);
    const bool more = s > m;
    r = fmaxf(r, fminf(m, s));
    m = more ? s : m;
    first = more ? p.w : first;
  }
  float l0, l1, l2;
  if (r == m || (pad > 0 && first == 0.0f)) {
    // a tie: the mean of the maximisers, summed in index order (from -0,
    // so the first term is taken as it is), padding last
    float cnt = 0.0f, sx = -0.0f, sy = -0.0f, sz = -0.0f;
    for (int i = 0; i < n; ++i) {
      const float4 p = sv[i];
      const bool tie = row_dot(p, dl0, dl1, dl2) == m;
      cnt = tie ? cnt + 1.0f : cnt;
      sx = tie ? sx + p.x : sx;
      sy = tie ? sy + p.y : sy;
      sz = tie ? sz + p.z : sz;
    }
    const float4 p0 = sv[0];
    if (pad > 0 && row_dot(p0, dl0, dl1, dl2) == m) {
      const float k = static_cast<float>(pad);
      cnt += k;
      sx = fmaf(k, p0.x, sx);
      sy = fmaf(k, p0.y, sy);
      sz = fmaf(k, p0.z, sz);
    }
    const float inv = 1.0f / cnt;
    l0 = sx * inv;
    l1 = sy * inv;
    l2 = sz * inv;
  } else {
    const float4 p = sv[static_cast<int>(first)];
    l0 = p.x;
    l1 = p.y;
    l2 = p.z;
  }
  return v3(op(ops, kR + 0) * l0 + op(ops, kR + 1) * l1 + op(ops, kR + 2) * l2 + op(ops, kT),
            op(ops, kR + 3) * l0 + op(ops, kR + 4) * l1 + op(ops, kR + 5) * l2 + op(ops, kT + 1),
            op(ops, kR + 6) * l0 + op(ops, kR + 7) * l1 + op(ops, kR + 8) * l2 + op(ops, kT + 2));
}

// Capsule (segment + ball) or, where cyl, flat-capped cylinder support.
__device__ __forceinline__ V3 support_obstacle(const float* ops, V3 d) {
  const V3 p0 = op3(ops, kP0), p1 = op3(ops, kP1), an = op3(ops, kAn);
  const float r = op(ops, kRad);
  const float inv_dn = 1.0f / (sqrtf(dot(d, d)) + kEps);
  const V3 end = sel(dot(d, sub(p1, p0)) > 0.0f, p1, p0);
  const V3 cap = add(end, scale(r * inv_dn, d));
  const float d_ax = dot(d, an);
  const V3 d_perp = sub(d, scale(d_ax, an));
  const float inv_p = 1.0f / (sqrtf(dot(d_perp, d_perp)) + kEps);
  const V3 end_c = sel(d_ax > 0.0f, p1, p0);
  const V3 cyl_pt = add(end_c, scale(r, scale(inv_p, d_perp)));
  return sel(op(ops, kCyl) > 0.5f, cyl_pt, cap);
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
  __shared__ int s_rows;  // rows up to the last one that differs from row 0
  const int tid = threadIdx.x;
  const int lm = blockIdx.y;  // link * M + slot
  const int l = lm / M;
  const float* vl = verts + static_cast<size_t>(l) * V * 3;
  if (tid == 0) s_rows = 1;
  __syncthreads();
  for (int i = tid; i < V; i += kThreads) {
    const float x = vl[3 * i], y = vl[3 * i + 1], z = vl[3 * i + 2];
    sv[i] = make_float4(x, y, z, static_cast<float>(i));
    if (__float_as_int(x) != __float_as_int(vl[0]) ||
        __float_as_int(y) != __float_as_int(vl[1]) ||
        __float_as_int(z) != __float_as_int(vl[2]))
      atomicMax(&s_rows, i + 1);
  }

  // the ragged tail computes on env B - 1 and stores nothing, so every warp
  // is whole for __all_sync
  const int b_raw = blockIdx.x * kThreads + tid;
  const int b = b_raw < B ? b_raw : B - 1;
  const size_t sB = static_cast<size_t>(B);
  const size_t pair_off = static_cast<size_t>(lm) * 3 * sB + b;
  float* ops = reinterpret_cast<float*>(sv + V) + tid;
#pragma unroll
  for (int k = 0; k < 9; ++k)
    ops[(kR + k) * kThreads] = Rg[(static_cast<size_t>(l) * 9 + k) * sB + b];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ops[(kT + c) * kThreads] = tg[(static_cast<size_t>(l) * 3 + c) * sB + b];
    ops[(kP0 + c) * kThreads] = p0g[pair_off + c * sB];
    ops[(kP1 + c) * kThreads] = p1g[pair_off + c * sB];
    ops[(kAn + c) * kThreads] = ang[pair_off + c * sB];
  }
  ops[kRad * kThreads] = radius[static_cast<size_t>(lm) * sB + b];
  ops[kCyl * kThreads] = is_cyl[static_cast<size_t>(lm) * sB + b];
  const V3 d0 = v3(d0g[pair_off], d0g[pair_off + sB], d0g[pair_off + 2 * sB]);
  __syncthreads();
  const int n = s_rows, pad = V - s_rows;

  const V3 sa0 = support_link(sv, n, pad, ops, neg(d0));
  const V3 sb0 = support_obstacle(ops, d0);
  V3 Ya[4] = {sa0, sa0, sa0, sa0};
  V3 Yb[4] = {sb0, sb0, sb0, sb0};
  bool done = false;

  for (int it = 0; it < iters; ++it) {
    // a frozen pair's simplex never changes again: the warp stops when all
    // of its pairs are frozen, and a frozen pair idles until then
    if (__all_sync(0xffffffffu, done)) break;
    if (done) continue;
    V3 Yd[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) Yd[i] = sub(Ya[i], Yb[i]);
    V3 x;
    float lam[4];
    johnson<true>(Yd, x, lam);
    const V3 sa = support_link(sv, n, pad, ops, neg(x));
    const V3 sb = support_obstacle(ops, x);
    const float n2 = dot(x, x);
    const float gap = n2 - dot(x, sub(sa, sb));
    done = gap <= 1e-5f * n2 + 1e-12f;
    if (done) continue;
    // evict the first minimum-weight slot, rotate the old slot 0 into it,
    // insert the new support at slot 0
    const float m = fminf(fminf(lam[0], lam[1]), fminf(lam[2], lam[3]));
    bool taken = false;
    const V3 old_a = Ya[0], old_b = Yb[0];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool e = (lam[i] <= m) && !taken;
      taken = taken || e;
      Ya[i] = sel(e, old_a, Ya[i]);
      Yb[i] = sel(e, old_b, Yb[i]);
    }
    Ya[0] = sa;
    Yb[0] = sb;
  }
  if (b_raw >= B) return;

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
// `device` (the caller's current device is restored). Returns
// cudaGetLastError() after the launch, or -1 when V is outside [1, 2048]
// (nothing is launched then).
extern "C" int rmp_gjk_hull_f32(int device, int L, int M, int V, int B,
                                int iters, const float* verts, const float* R,
                                const float* t, const float* p0,
                                const float* p1, const float* an,
                                const float* radius, const float* is_cyl,
                                const float* d0, float* pa, float* pb,
                                float* dist, void* stream) {
  if (V < 1 || V > kMaxVerts) return -1;
  int previous = device;
  cudaGetDevice(&previous);
  if (previous != device) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  if (B > 0 && L > 0 && M > 0) {
    const dim3 grid((B + kThreads - 1) / kThreads, L * M);
    const int shmem = V * static_cast<int>(sizeof(float4)) +
                      static_cast<int>(sizeof(float)) * kFields * kThreads;
    if (shmem > 48 * 1024)  // above the default: opt in (up to 227 KB)
      cudaFuncSetAttribute(gjk_hull_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, shmem);
    gjk_hull_kernel<<<grid, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(
        M, V, B, iters, verts, R, t, p0, p1, an, radius, is_cyl, d0, pa, pb, dist);
  }
  const int rc = static_cast<int>(cudaGetLastError());
  if (previous != device) cudaSetDevice(previous);
  return rc;
}
