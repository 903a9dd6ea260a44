"""Where the time of the port's K1, K3, K4 and K5 calls goes, on one NVIDIA
GPU.

    python3 kernel_probe.py [part ...] [--against DIR]

Parts: sass, k3, k3narrow, k3tile, k3ab, k4, k5, k5wide, k5ab, k1, k1parts,
k1ab, k1cta, k1ctaab, sassab, host, traces. k5ab, k1ctaab and
sassab need --against; a run that names no part runs every part but those
that need --against where none is given, and names the parts it skips on
stderr (`choose_parts`).

1. Phase splits by edited copies of csrc/: each variant is rebuilt from a
   copy of csrc/ with an edit and runs in its own process (the library loads
   once per process); its kernel is timed with the stream kept busy ahead
   (chip_smoke.time_ms with lead), three medians of 30 calls each, and its
   ptxas counts are kept.
   - K3's wide kernel (part k3, csrc/fk_derivatives_wide.cuh) at
     B = 4096 on chip_smoke.k3_wide_models (the 24- and 32-link arms, n =
     19 and 31, 40 frames, the branched tree): return after q and the
     constants are in, skip every store (the recursion alone), skip J's
     stores, or skip the recursion's arithmetic (the stores alone); with
     the ptxas counts of both instantiations. Part k3narrow: the narrow
     kernel (csrc/fk_derivatives.cu) on the Panda and the dual-arm Panda:
     return after the table loads, after the prologue, before the stores
     or before J's stores, or skip the recursion. Part k3tile builds the
     wide kernel as it is, at 2 and 8 envs per CTA in place of 4, and
     launched without whole waves (always the layout's own shared
     memory).
     Part k3ab: the kernels against another checkout's (`--against DIR`)
     on the narrow and the wide layouts, each timed in K3_ROUNDS
     processes, the order turned every round, with each layout's largest
     |kernel - plain| / max(1, |plain|) over the outputs' entries, and a
     fill_ of as many floats as each wide layout writes (the card's write
     rate); it prints each layout's median of the medians.
   - K4 (csrc/gjk_hull.cu) on the hull main path's own warm operands
     (chip_smoke.k4_main_path_operands): the kernel as it is at iters = 0,
     1, 2 and 4 (fixed cost and cost per iteration), with the tie pass
     forced on every support, and built with a cap of 64 registers
     (__launch_bounds__(128, 8) in place of (128): one wave at the
     flagship, and spills).
   - K5 (csrc/fused_tick.cuh) at scene 06, B = 4096, near the ready pose:
     return after the FK recursion, after the frame slots, after the work
     items (before the butterfly), or the whole kernel.
   - K5's wide kernel (part k5wide, csrc/fused_tick_wide.cuh) at B = 4096
     on the 24- and 32-link arms (chip_smoke.k5_wide_layouts): return
     after the tables (q, qd, sin q, cos q, the first frame's entries),
     after the recursion, after the attractor and the identity leaves (the
     origin terms formed on the way), after the pairs, or the whole kernel
     (the Cholesky and both substitutions); each early return stores a
     value of the work done under a condition that never holds, so the
     compiler keeps that work. Part k5ab: the kernel
     against another checkout's (`--against DIR`) on every layout of
     chip_smoke.k5_wide_layouts and scene 06 on the 16-lane kernel, in
     K5_ROUNDS processes, the order turned every round, with each layout's
     largest |kernel - plain| / max(1, |plain|) on the envs whose plain
     run lies within K5_ACCURATE of float64; it prints each layout's median
     of the medians. Each child reports the layouts' shared bytes a CTA
     and envs an SM, and both instantiations' ptxas counts.
   - A diagnostic variant of K4 loads no table row in its first scan (its
     results are wrong; it times the scan's arithmetic alone).
   - K1's warp kernel (n = 10..32, part k1) at B = 4096 at n = 12 and 32
     (random layout), n = 18 (the randomized dual scene's and the
     handover's real ticks, made through the plain versions) and n = 24,
     32 (the planar arms' real ticks):
     return after the rows are staged and accumulated, after [A | f] is
     formed, after the elimination, or the whole kernel; with the ptxas
     counts of those four instantiations. The library of these variants
     holds K1's sources alone, and their inputs are made through the
     plain versions. Part k1parts: diagnostic variants (wrong results)
     that leave out the staging, the rows' sums into the tiles or the
     identity blocks' sums, and the kernel with larger tiles at n <= 20.
     Part k1ab: the kernel against the one in another checkout's csrc/
     (`--against DIR`, e.g. the parent commit unpacked by git archive)
     and against variants that prefetch the blocks ahead into L2, each
     timed in K1_ROUNDS processes, the order turned every round, with
     each layout's largest |q̈ - plain| / max(1, |plain|). A variant that
     fails to build or run is reported and the probe exits 1.
   - K1's CTA kernel (n = 33..64, part k1cta) at B = 4096 on
     K1CTA_LAYOUTS (the 33- and 64-link arms' real ticks, random n = 36,
     40, 41, 47, 48, 63, 64: each instantiation's ends, 40 | 41 its
     boundary): every block staged with the identity blocks' rows not added
     (the scalar and dense rows' sums), all sums, the elimination, or the
     whole kernel, with both instantiations' ptxas counts and each
     layout's shared bytes and envs an SM; with --against DIR also DIR's
     kernel where it is the design with [A | f] in shared memory that this
     one replaced (K1CTA_SMEM: after the tiles' sums, after the identity
     blocks, after the elimination, whole). Part k1ctaab: the
     kernel against DIR's in K1_ROUNDS processes, the order turned every
     round, with each layout's largest |q̈ - plain| / max(1, |plain|) and
     its median of the medians.
   - Part sassab (--against DIR): every kernel's SASS (cuobjdump -sass) in
     this tree's library against the kernel of the same name in DIR's,
     built from DIR's csrc/; an anonymous namespace's per-file name and
     hashes are one token and a line's padding is collapsed, so a kernel
     moved to another source compares as itself.
2. Instructions per kernel and their opcodes, from cuobjdump -sass of the
   built library (the listing goes to
   chiprun_out/kernel_probe_sass.txt.gz).
3. Host cost of the K1 and K3 wrappers' parts (validation and descriptor
   table, allocation, stream handle) and of whole wrapper calls at
   B = 16, in microseconds per call over 2,000 calls.
4. Device records the profiler keeps (traces): a child process runs
   chip_smoke.py's phases, then traces 10 K5 calls at scenes 06 and 05,
   30 times each way per scene, alternating in rounds of 10: started and
   stopped around the calls alone (how chip_smoke.py traced before), and
   through chip_smoke.traced (a warm-up step first, a pause on each side).
   It counts the device kernels each trace recorded and the host's launch
   calls.
The results also go to chiprun_out/kernel_probe.json. Needs CUDA and nvcc.
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
STOP = "  if (F > 0) return;\n"
K3_RECURSION = "  // ---- the recursion (fk_common.cuh): env e, entry (i, j) ----\n  {"
K5_SLOTS = "  // ---- the point frames' slots"
K5_ITEMS = "  // ---- work items:"
K5_BUTTERFLY = "  // ---- butterfly over the env's 16 lanes ----"

# source -> variant -> edits of that source: (old, new), or (file, old,
# new) for another file of csrc/
K3_WIDE = "fk_derivatives_wide.cuh"
K3_FRAMES = "  // ---- the frames, in topological order ----"
K3_STEP = "    {  // ---- the step of frame f: T, G, W, Wd ----"
K3_ROWS = "    // ---- frame f's rows of T, Td and c ----"
K3_J = "    // ---- frame f's row of J: motors r + 16 k ----"
VARIANTS = {
    K3_WIDE: {
        "full": [],
        "tables_only": [(K3_FRAMES, STOP + K3_FRAMES)],
        "no_stores": [(K3_ROWS, "    if (F > 0) continue;\n" + K3_ROWS)],
        "no_J_stores": [(K3_J, "    if (F > 0) {\n      __syncwarp();\n"
                         "      continue;\n    }\n" + K3_J)],
        "no_recursion": [(K3_STEP, K3_STEP.replace("    {", "    if (F < 0) {"))],
    },
    "fk_derivatives.cu": {
        "full": [],
        "tables_only": [("  // ---- per frame, once:",
                         STOP + "  // ---- per frame, once:")],
        "tables_and_prologue": [(K3_RECURSION, STOP + "  {")],
        "no_stores": [("  __syncthreads();\n\n  // ---- the stores",
                       "  __syncthreads();\n" + STOP
                       + "  // ---- the stores")],
        "no_J_stores": [("  // J: a row's 16 n floats",
                         STOP + "  // J: a row's 16 n floats")],
        "no_recursion": [(K3_RECURSION, "  if (F < 0) {")],
    },
    "gjk_hull.cu": {
        "full": [],
        "tie_pass_forced": [("  if (r == m || (pad > 0 && first == 0.0f)) {",
                             "  if (true) {")],
        "register_cap_64": [("__launch_bounds__(kThreads) gjk_hull_kernel",
                             "__launch_bounds__(kThreads, 8) gjk_hull_kernel")],
        # diagnostic, wrong results: the first scan's rows from registers
        "scan_without_table_loads": [(
            "    const float4 p = sv[i];\n    const float s = row_dot(",
            "    const float4 p = make_float4(0.01f * i, 0.02f * i, "
            "-0.01f * i, i);\n    const float s = row_dot(")],
    },
    "fused_tick.cuh": {
        "full": [],
        "fk_only": [(K5_SLOTS, STOP + K5_SLOTS)],
        "fk_and_slots": [(K5_ITEMS, STOP + K5_ITEMS)],
        "no_reduction_or_solve": [(K5_BUTTERFLY, STOP + K5_BUTTERFLY)],
    },
}


def k3_wide_envs(envs: int) -> list:
    """Edits that give the wide kernel's tile `envs` envs per CTA."""
    return [("constexpr int kWideEnvs = 4;", f"constexpr int kWideEnvs = {envs};"),
            ("fk_derivatives.cu", "{{32, 18, 8}, {40, 32, 4}, {72, 64, 2}};",
             f"{{{{32, 18, 8}}, {{40, 32, {envs}}}, {{72, 64, 2}}}};")]


# the wide kernel's tile at 2 and 8 envs per CTA (the kernel has 4), and
# its launch without whole waves (the layout's own shared memory always)
K3_TILES = {K3_WIDE: {"full": [], "wide_tile_2": k3_wide_envs(2),
                      "wide_tile_8": k3_wide_envs(8),
                      "unbalanced_waves": [(
                          "fk_wide_launch.cuh",
                          "    if (d.sms == 0) return bytes;",
                          "    if (d.sms >= 0) return bytes;")]}}
# part k3ab: the kernels as they are against another checkout's
K3_AB = {K3_WIDE: {"full": []}}


def k5_stop(anchor: str, guard: str) -> list:
    """An edit that returns before `anchor`, after a store of `guard` (a
    value of the work done so far) under a condition that never holds, so
    the compiler keeps that work."""
    return [(anchor, f"  if ({guard} == 1.2345e-30f) out[threadIdx.x] = 1.0f;\n"
             + STOP + anchor)]


# the sum of the lane's row of [A | f]: the guard of the later stops
K5_ROW_SUM = "row_sum(row, fr)"
K5_ROW_SUM_FN = ("template <int N>\n__device__ __forceinline__ float row_sum("
                 "const float (&row)[N], float fr) {\n#pragma unroll\n  for "
                 "(int c = 0; c < N; ++c) fr += row[c];\n  return fr;\n}\n\n")
# the wide kernel's split on its own markers (part k5wide)
K5_WIDE = "fused_tick_wide.cuh"
W_FRAMES = "  // ---- the frames, in topological order ----"
W_ROWS = "  // rows r and r + 16 of [A | f]"
W_PAIRS = "  // ---- the pairs, 16 staged at a time ----"
W_CHOL = "  // ---- Cholesky of the symmetrized A"
W_KERNEL = ("template <int N>\n__global__ void __launch_bounds__(kThreads, 4) "
            "fused_qdd_wide_kernel(")
W_ROW_SUM = "row_sum(rowA, fA + dA) + row_sum(rowB, fB + dB)"
K5_WIDE_SPLITS = {K5_WIDE: {
    "full": [],
    "tables": k5_stop(W_FRAMES, "qA + qdA + qB + qdB + sinA + cosA + sinB + "
                      "cosB + next.tc.x"),
    "recursion": k5_stop(W_ROWS, "s[L.D + kRows3 * (F - 1) + r % 12]"),
    "slots_attractor_identity": [(W_KERNEL, K5_ROW_SUM_FN + W_KERNEL)]
    + k5_stop(W_PAIRS, W_ROW_SUM),
    "pairs": [(W_KERNEL, K5_ROW_SUM_FN + W_KERNEL)]
    + k5_stop(W_CHOL, W_ROW_SUM),
}}
# part k5ab: the wide kernel as it is against another checkout's
K5_AB = {K5_WIDE: {"full": []}}
K5_ROUNDS = 3
K3_ROUNDS = 3
K4_ITERS = (0, 1, 2, 4)
# K1's warp kernel (n = 10..32): return after the rows are staged and
# accumulated, after [A + ridge I | f] is formed (the identity seed added),
# after the elimination
K1_STOP = "  if (B > 0) return;\n"
K1_SOURCE = "pullback_resolve_wide.cuh"
K1_SPLITS = {
    K1_SOURCE: {
        "full": [],
        "accumulated": [("  // ---- rows of [A + ridge I | f]",
                         K1_STOP + "  // ---- rows of [A + ridge I | f]")],
        "rows_formed": [("  // ---- elimination ----",
                         K1_STOP + "  // ---- elimination ----")],
        "eliminated": [("  // ---- back substitution, by columns ----",
                        K1_STOP + "  // ---- back substitution, by columns "
                        "----")],
    },
}
K1_PROBE_N = (12, 18, 24, 32)
# diagnostic variants of the warp kernel (part k1parts; wrong results):
# the staging, the rows' sums into the tiles, the identity blocks' sums
# each left out
K1_PARTS = {
    K1_SOURCE: {
        "full": [],
        "no_staging": [("  if (blk.elem == kBFloat16)\n    stage_chunk<N, P, "
                        "bf16_t>", "  if (b >= 0) return;\n  if (blk.elem "
                        "== kBFloat16)\n    stage_chunk<N, P, bf16_t>")],
        "no_row_sums": [
            ("      constexpr int kC = chunk_rows(N, kScalar);\n      if "
             "(active) {", "      constexpr int kC = chunk_rows(N, "
             "kScalar);\n      if (b < 0) {"),
            ("      constexpr int kD = chunk_rows(N, kDense);\n      if "
             "(active) {", "      constexpr int kD = chunk_rows(N, "
             "kDense);\n      if (b < 0) {")],
        "no_identity_sums": [("      if (active && group == 0) {",
                              "      if (b < 0) {")],
        # up to 36 tile entries a lane at n <= 20 (24 in the kernel)
        "acc_36_to_n20": [("  return n <= 20 ? 24 : n <= 28",
                           "  return n <= 20 ? 36 : n <= 28")],
    },
}


# part k1ab: the warp kernel against another checkout's (`--against DIR`)
# and against variants that prefetch blocks ahead into L2, K1_AHEAD blocks
# before the ring stages them (each contiguous run of a block's tensors a
# lane, a line at a time), all timed in K1_ROUNDS rounds of a process each,
# the order turned every round
K1_ROUNDS = 3
K1_PREFETCH = r"""// L2 prefetches of rows 0..nr-1, columns 0..nc-1 of env b
// of a block tensor (es bytes an element; nc = 1: a vector along s[1]):
// each contiguous run a lane, a line at a time
__device__ __forceinline__ void prefetch_rows(const void* p,
                                              const long long* s, int es,
                                              long long b, int nr, int nc,
                                              int lane) {
  const long long srow = s[1] < 0 ? -s[1] : s[1];
  const long long scol = s[2] < 0 ? -s[2] : s[2];
  const bool along = nc == 1 || srow <= scol;
  const int runs = along ? nc : nr, len = along ? nr : nc;
  const long long step = along ? s[2] : s[1];
  const long long inner = along ? s[1] : s[2];
  const long long ib = (inner < 0 ? -inner : inner) * es;
  if (ib > 128 || len < 1) return;
  const long long span = (len - 1) * ib;
  const char* base = static_cast<const char*>(p) + b * s[0] * es +
                     (inner < 0 ? (len - 1) * inner * es : 0);
  for (int r = lane; r < runs; r += 32) {
    const char* lo = base + (runs > 1 ? r * step * es : 0);
    for (long long o = 0; o < span + 128; o += 128) {
      const char* a = lo + (o < span ? o : span);
      asm volatile("prefetch.L2 [%0];\n" ::"l"(a));
    }
  }
}
template <int N>
__device__ __forceinline__ void prefetch_block(const Block& blk, long long b,
                                               int lane) {
  const int es = blk.elem == kBFloat16 ? 2 : 4;
  const int R = block_rows(blk, N);
  prefetch_rows(blk.ptr[0], blk.stride[0], es, b, R, N, lane);
  prefetch_rows(blk.ptr[1], blk.stride[1], es, b, R,
                blk.kind == kDense ? N : 1, lane);
  if (blk.kind != kIdentity)
    prefetch_rows(blk.ptr[2], blk.stride[2], es, b, R, 1, lane);
}

"""
K1_KERNEL = ("template <int N>\n"
             "__global__ void __launch_bounds__(32 * kEnvs, 8)")
K1_NEXT = "  int ik = 0, ir0 = 0;  // the next chunk to stage\n"
K1_STAGE = ("      const Block& blk = table.block[ik];\n"
            "      stage_any<N, P>(ring + ((slot")


def k1_prefetch(ahead: int) -> list:
    """Edits of the warp kernel that prefetch `ahead` blocks ahead."""
    return [(K1_KERNEL, K1_PREFETCH + K1_KERNEL),
            (K1_NEXT, K1_NEXT + f"  for (int d = 1; d <= {ahead} && d < "
             "table.count; ++d)\n    prefetch_block<N>(table.block[d], b, "
             "lane);\n"),
            (K1_STAGE, K1_STAGE.replace(
                "      stage_any", f"      if (ir0 == 0 && ik + {ahead} < "
                "table.count)\n        prefetch_block<N>(table.block[ik + "
                f"{ahead}], b, lane);\n      stage_any"))]


K1_AB = {K1_SOURCE: {"full": [], "prefetch_1": k1_prefetch(1),
                     "prefetch_2": k1_prefetch(2)}}

# K1's CTA kernel (n = 33..64, part k1cta): return after the scalar and
# dense rows' sums, after the identity blocks, after the elimination, or the
# whole kernel; each early return first stores, under a condition that never
# holds, a value of the work done, so the compiler keeps that work. On
# K1CTA_LAYOUTS, with the ptxas counts of each instantiation. With
# --against DIR the same split of DIR's CTA kernel, where it is the design
# with [A | f] in shared memory that this one replaced (K1CTA_SMEM, its own
# markers), runs too.
K1CTA_SOURCE = "pullback_resolve_cta.cuh"
K1CTA_STOP = "  if (n > 0) return;\n"
# (name, n, the planar arm's real tick or else the random layout
# chip_smoke.K1_EVERY_N_LAYOUT)
K1CTA_LAYOUTS = (("n=33 planar real tick", 33, True),
                 ("n=36 random", 36, False), ("n=40 random", 40, False),
                 ("n=41 random", 41, False), ("n=47 random", 47, False),
                 ("n=48 random", 48, False), ("n=63 random", 63, False),
                 ("n=64 random", 64, False),
                 ("n=64 planar real tick", 64, True))


def k1cta_stop(anchor: str, guard: str) -> list:
    """An edit that returns before `anchor`, after storing `guard` (a value
    of the work done) where it equals a number it never takes."""
    return [(anchor, f"  if ({guard} == 1.2345e-30f) out[b] = 1.0f;\n"
             + K1CTA_STOP + anchor)]


K1CTA_KERNEL = ("template <int kMaxN>\n__global__ void __launch_bounds__(32, "
                "Shape<kMaxN>::ctas)")
K1CTA_ROW_SUM = [(K1CTA_KERNEL, K5_ROW_SUM_FN.replace("row_sum(const float (&row)"
                                                      "[N], float fr)",
                                                      "row_sum(const float "
                                                      "(&row)[N], float fr "
                                                      "= 0.0f)")
                  + K1CTA_KERNEL)]
K1CTA_GUARD = "row_sum(r0) + row_sum(r1)"
K1CTA_SPLITS = {K1CTA_SOURCE: {
    "full": [],
    # every block staged, the scalar and dense rows summed, the identity
    # blocks' rows not added
    "rows_sums": K1CTA_ROW_SUM + [(
        "      if (i >= 0 && i < nr) {",
        "      if (i >= 0 && i < nr && n < 0) {")]
    + k1cta_stop("  // ---- the ridge ----", K1CTA_GUARD),
    "sums": K1CTA_ROW_SUM + k1cta_stop("  // ---- the ridge ----", K1CTA_GUARD),
    "eliminated": K1CTA_ROW_SUM + k1cta_stop(
        "  // ---- back substitution, by columns ----", K1CTA_GUARD),
}}
# the replaced CTA kernel ([A | f] in shared memory): its own markers
K1CTA_SMEM_SUMS = ("#pragma unroll\n  for (int i = 0; i < A; ++i)\n"
                   "#pragma unroll\n    for (int j = 0; j < Bt; ++j) "
                   "sums += acc[i][j];\n")
K1CTA_SMEM = {K1CTA_SOURCE: {
    "full": [],
    "sums": [("  // ---- the tiles into [A | f] (over the ring) ----",
              "  float sums = 0.0f;\n" + K1CTA_SMEM_SUMS
              + "  if (sums == 1.2345e-30f) out[b] = 1.0f;\n" + K1CTA_STOP
              + "  // ---- the tiles into [A | f] (over the ring) ----")],
    "identity": k1cta_stop("  // ---- elimination ----", "sA[tid]"),
    "eliminated": k1cta_stop("  // ---- back substitution, by columns, on "
                             "warp 0 ----", "sA[tid]"),
}}
# part k1ctaab: the CTA kernel as it is against another checkout's
K1CTA_AB = {K1CTA_SOURCE: {"full": []}}


CHILD = r"""
import json, sys
sys.path.insert(0, {root!r})
import torch
from rmp_tpu_torch import _build, envs
_build.CSRC_DIR, _build.BUILD_DIR = {csrc!r}, {build!r}
import chip_smoke as cs
from rmp_tpu_torch.models import robots
from rmp_tpu_torch.ops import cuda_fk, cuda_gjk, cuda_tick
_build.build()
src = {src!r}
if src.startswith("fk_derivatives"):
    from rmp_tpu_torch.models.fk_derivatives import fk_derivatives
    models = {{}}
    if src == "fk_derivatives.cu" or {k3_all!r}:
        models.update(panda=robots.franka_panda(),
                      dual_panda=robots.dual_panda())
    if src != "fk_derivatives.cu":
        models.update(cs.k3_wide_models())
    calls, err = {{}}, {{}}
    for name, model in models.items():
        q, qd = cs.k3_inputs(model, cs.BATCH, torch.device("cuda"))
        calls[name] = (lambda m=model, q=q, qd=qd:
                       cuda_fk.fk_derivatives_batched(m, q, qd))
        if {k3_all!r}:
            # the largest |kernel - plain| / max(1, |plain|) over the
            # outputs' entries
            got, want = calls[name](), fk_derivatives(model, q, qd)
            err[name] = max(float(((g - w).abs() / w.abs().clamp(min=1.0))
                                  .max()) for g, w in zip(got, want))
    if {k3_all!r}:
        # the card's write rate on the wide layouts' bytes: one fill_ of
        # as many floats as the kernel writes
        for name, model in list(models.items())[2:]:
            F, n = model.n_frames, model.n_q
            buf = torch.empty(cs.BATCH * F * 16 * (3 + n), device="cuda")
            calls["fill " + name] = lambda buf=buf: buf.fill_(0.0)
elif src == "gjk_hull.cu":
    ops, _ = cs.k4_main_path_operands()
    calls = {{f"iters{{i}}": (lambda i=i: cuda_gjk.gjk_hull_obstacles(
        **ops, iters=i)) for i in {iters!r}}}
elif src == {k1cta!r}:
    # K1's CTA kernel on K1CTA_LAYOUTS, the inputs made through the plain
    # versions and saved by the first variant's process, as below
    from rmp_tpu_torch.envs import planar
    from rmp_tpu_torch.ops import cuda_resolve
    import os
    dev = torch.device("cuda")
    if os.path.exists({inputs!r}):
        inputs, want = torch.load({inputs!r}, map_location=dev)
    else:
        with cs.plain_kernels():
            inputs = {{}}
            for name, n, real in {k1cta_layouts!r}:
                inputs[name] = (cs.real_tick_blocks(
                    planar.planar_arm_env(n), cs.BATCH, n) if real else
                    cs.k1_device_blocks(n, cs.BATCH, n,
                                        cs.K1_EVERY_N_LAYOUT, dev))
        want = {{k: cuda_resolve.pullback_resolve_structured_plain(t, b)
                 for k, (t, b) in inputs.items()}}
        torch.save((inputs, want), {inputs!r})
    calls = {{k: (lambda t=t, b=b: cuda_resolve.pullback_resolve_structured(
        t, b)) for k, (t, b) in inputs.items()}}
    # |q̈ - plain| / max(1, |plain|) where the plain version is finite, and
    # the envs whose finiteness differs
    err, nonfinite = {{}}, {{}}
    for k, fn in calls.items():
        got, ref = fn(), want[k]
        fin = torch.isfinite(ref).all(1)
        err[k] = float(((got[fin] - ref[fin]).abs()
                        / ref[fin].abs().clamp(min=1.0)).max())
        nonfinite[k] = int((torch.isfinite(got).all(1) != fin).sum())
elif src.startswith("pullback_resolve"):
    from rmp_tpu_torch.envs import planar
    from rmp_tpu_torch.ops import cuda_resolve
    dev = torch.device("cuda")
    # the inputs come through the plain versions (the dual scene's from a
    # rollout), so that no variant's results reach them and the library
    # needs K1 alone; the first variant's process saves them (views and
    # strides kept) for the others
    import os
    if os.path.exists({inputs!r}):
        inputs, want = torch.load({inputs!r}, map_location=dev)
    else:
        with cs.plain_kernels():
            inputs = {{
                "n=12 random": cs.k1_device_blocks(12, cs.BATCH, 12,
                                                   cs.K1_EVERY_N_LAYOUT, dev),
                "n=18 randomized dual": cs.dual_tick_blocks(
                    cs.DUAL_RANDOMIZED)[cs.BATCH],
                "n=18 handover": cs.dual_tick_blocks(
                    cs.DUAL_HANDOVER)[cs.BATCH],
                "n=24 planar real tick": cs.real_tick_blocks(
                    planar.planar_arm_env(24), cs.BATCH, 24),
                "n=32 random": cs.k1_device_blocks(32, cs.BATCH, 32,
                                                   cs.K1_EVERY_N_LAYOUT, dev),
                "n=32 planar real tick": cs.real_tick_blocks(
                    planar.planar_arm_env(32), cs.BATCH, 32)}}
        want = {{k: cuda_resolve.pullback_resolve_structured_plain(t, b)
                 for k, (t, b) in inputs.items()}}
        torch.save((inputs, want), {inputs!r})
    calls = {{k: (lambda t=t, b=b: cuda_resolve.pullback_resolve_structured(
        t, b)) for k, (t, b) in inputs.items()}}
    # |q̈ - plain| / max(1, |plain|) where the plain version is finite (the
    # split's variants return early: theirs is no result), and the envs
    # whose finiteness differs
    err = {{}}
    for k, fn in calls.items():
        got, ref = fn(), want[k]
        fin = torch.isfinite(ref).all(1)
        err[k] = [float(((got[fin] - ref[fin]).abs()
                         / ref[fin].abs().clamp(min=1.0)).max())
                  if fin.any() else 0.0,
                  int((torch.isfinite(got).all(1) != fin).sum())]
elif src.startswith("fused_tick_wide"):
    # the wide K5 at B = 4096: the 24- and 32-link arms (the split), or
    # every layout of chip_smoke.k5_wide_layouts with its largest error on
    # the held envs and scene 06 on the 16-lane kernel (k5ab)
    layouts = cs.k5_wide_layouts()
    if not {k3_all!r}:
        layouts = {{k: v for k, v in layouts.items()
                    if k in ("planar_24", "planar_32")}}
    calls, err, shared = {{}}, {{}}, {{}}
    for name, (env, args) in layouts.items():
        tick = cuda_tick.fused_tick(env)
        fn = cuda_tick.make_fused_qdd(env)
        calls[name] = lambda fn=fn, args=args: fn(*args)
        shared[name] = cs.k5_wide_residency(tick)
        if {k3_all!r}:
            err[name] = cs.k5_held_error(tick, args)
    if {k3_all!r}:
        env06 = envs.make(cs.SCENE)
        fn06 = cuda_tick.make_fused_qdd(env06)
        near = cs.k5_inputs(env06, cs.BATCH, 11, wide=False)
        calls["scene 06 (16-lane)"] = lambda: fn06(*near)
else:
    env = envs.make(cs.SCENE)
    fn = cuda_tick.make_fused_qdd(env)
    near = cs.k5_inputs(env, cs.BATCH, 11, wide=False)
    calls = dict(call=lambda: fn(*near))
extra = (dict(build_narrow=cs.ptxas_counts(
    "fk_derivatives_wide.cuh", "fk_derivatives_kernelILi32ELi18E"),
               build_wide=cs.ptxas_counts("fk_derivatives_wide.cuh",
                                          "ILi40ELi32E"))
    if src.startswith("fk_derivatives")
    else {{f"build_{{m}}": cs.ptxas_counts(
        src, f"pullback_resolve_cta_kernelILi{{m}}E") for m in (40, 48, 64)}}
    if src == {k1cta!r}
    else {{f"build_n{{n}}": cs.ptxas_counts(
        src, f"pullback_resolve_wide_kernelILi{{n}}E") for n in {k1_n!r}}}
    if src.startswith("pullback_resolve")
    else {{f"build_n{{n}}": cs.ptxas_counts(
        src, f"fused_qdd_wide_kernelILi{{n}}E") for n in (24, 32)}}
    if src.startswith("fused_tick_wide") else {{}})
if src.startswith("fused_tick_wide"):
    extra["residency"] = shared
if src == {k1cta!r}:
    extra["nonfinite"] = nonfinite
    if hasattr(_build.load(), "rmp_pullback_resolve_cta_residency"):
        extra["residency"] = {{n: cs.k1_cta_residency(n)
                              for n in sorted({{n for _, n, _ in
                                               {k1cta_layouts!r}}})}}
if src.startswith("pullback_resolve") or {k3_all!r}:
    extra["err"] = err
print("RESULT", json.dumps(dict(
    build=cs.ptxas_counts(src), **extra,
    device_ms={{k: [cs.time_ms(c, lead=True) for _ in range(3)]
               for k, c in calls.items()}})))
"""


BUILD_CHILD = r"""
import sys
sys.path.insert(0, {root!r})
from rmp_tpu_torch import _build
_build.CSRC_DIR, _build.BUILD_DIR = {csrc!r}, {build!r}
_build.build()
"""


def split(source: str, variants: dict = VARIANTS, only: str | None = None,
          rounds: int = 1, against: str | None = None,
          k3_all: bool = False, base: str = ROOT) -> dict:
    """Every variant of `source` built (all at once, a process each) and
    then timed in its own process, one after the other; with `rounds` > 1
    that many times, the order turned every round, and a variant's results
    are a list, one a round. `only`: the sources whose names start so are
    the library's (the headers always). `against`: a checkout whose csrc/,
    unedited, is one more variant ("against"). A variant whose edit anchor
    is not found once, or that fails to build or to run, is reported
    (`error`) and left out of later rounds.
    `k3_all`: K3's children time the narrow and the wide layouts and
    report each one's error against the plain version (the wide K5's
    children every layout, and scene 06). `base`: the checkout whose csrc/
    the variants edit (this one by default)."""
    out, works = {}, {}
    cache = tempfile.mkdtemp()
    inputs = os.path.join(cache, "inputs.pt")   # K1's, made once
    todo = dict(variants[source])
    if against is not None:
        todo["against"] = None
    try:
        for name, edits in todo.items():
            src_dir = os.path.join(base if edits is not None else against,
                                   "rmp_tpu_torch", "csrc")
            keep = (None if only is None else shutil.ignore_patterns(*(
                f for f in os.listdir(src_dir)
                if f.endswith(".cu") and not f.startswith(only))))
            work = works[name] = tempfile.mkdtemp()
            csrc = os.path.join(work, "csrc")
            shutil.copytree(src_dir, csrc, ignore=keep)
            if not edits:
                continue
            for edit in edits:
                target, old, new = (source, *edit) if len(edit) == 2 else edit
                path = os.path.join(csrc, target)
                with open(path) as f:
                    text = f.read()
                if text.count(old) != 1:
                    out[name] = dict(error=f"{target}: edit anchor not "
                                     f"found once: {old.strip()[:60]!r}")
                    print(f"{source} {name}: {out[name]['error']}",
                          flush=True)
                    break
                with open(path, "w") as f:
                    f.write(text.replace(old, new))
        builds = {name: subprocess.Popen(
            [sys.executable, "-c", BUILD_CHILD.format(
                root=ROOT, csrc=os.path.join(work, "csrc"),
                build=os.path.join(work, "build"))], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for name, work in works.items() if name not in out}
        for name, proc in builds.items():
            _, err = proc.communicate(timeout=900)
            if proc.returncode != 0:
                out[name] = dict(error=f"build failed:\n{err[-4000:]}")
                print(f"{source} {name}: {out[name]['error']}", flush=True)
        names = [n for n in works if n not in out]
        runs: dict[str, list] = {n: [] for n in names}
        for r in range(rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                if name in out:
                    continue
                work = works[name]
                code = CHILD.format(root=ROOT, csrc=os.path.join(work, "csrc"),
                                    build=os.path.join(work, "build"),
                                    src=source, iters=K4_ITERS,
                                    k1_n=K1_PROBE_N, inputs=inputs,
                                    k3_all=k3_all, k1cta=K1CTA_SOURCE,
                                    k1cta_layouts=K1CTA_LAYOUTS)
                run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                                     capture_output=True, text=True,
                                     timeout=600)
                lines = [ln for ln in run.stdout.splitlines()
                         if ln.startswith("RESULT ")]
                if run.returncode != 0 or not lines:
                    out[name] = dict(error=f"run failed:\n"
                                     f"{run.stderr[-4000:]}")
                    print(f"{source} {name}: {out[name]['error']}",
                          flush=True)
                    continue
                runs[name].append(json.loads(lines[0][len("RESULT "):]))
                print(f"{source} {name} (round {r + 1}): "
                      f"{json.dumps(runs[name][-1])}", flush=True)
        for name in names:
            if name not in out:
                out[name] = runs[name][0] if rounds == 1 else runs[name]
    finally:
        for work in list(works.values()) + [cache]:
            shutil.rmtree(work, ignore_errors=True)
    return out


def medians(out: dict, part: str = "k3ab") -> dict:
    """Part k3ab's (k5ab's) summary, printed and kept under "summary": per layout,
    each variant's median over its rounds' medians, the against
    checkout's over the kernel's, and the largest error of any round."""
    runs = {k: v for k, v in out.items() if isinstance(v, list)}
    summary: dict = {}
    for name, rounds in runs.items():
        for layout in rounds[0]["device_ms"]:
            rec = summary.setdefault(layout, {})
            rec[name] = statistics.median(
                m for r in rounds for m in r["device_ms"][layout])
            if layout in rounds[0]["err"]:
                rec[f"{name}_err"] = max(r["err"][layout] for r in rounds)
    for layout, rec in summary.items():
        if "full" in rec and "against" in rec:
            rec["speed_up"] = rec["against"] / rec["full"]
        print(f"{part} {layout}: " + ", ".join(
            f"{k} {v:.4f}" if not k.endswith("_err") else f"{k} {v:.2e}"
            for k, v in rec.items()), flush=True)
    out["summary"] = summary
    return out


def sass_counts() -> dict:
    """Instructions per kernel of the built library (cuobjdump -sass), with
    each kernel's opcode histogram; the listing goes to
    chiprun_out/kernel_probe_sass.txt.gz."""
    from rmp_tpu_torch import _build

    lib = _build.build()
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with gzip.open(os.path.join(ROOT, "chiprun_out",
                                "kernel_probe_sass.txt.gz"), "wt") as f:
        f.write(text)
    out = {}
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split("\n", 1)[0].strip()
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                         chunk)
        hist: dict[str, int] = {}
        for op in ops:
            hist[op.split(".")[0]] = hist.get(op.split(".")[0], 0) + 1
        out[name] = dict(instructions=len(ops), opcodes=dict(
            sorted(hist.items(), key=lambda kv: -kv[1])))
        short = re.search(r"[a-z_]*kernel[a-z_]*(?:I(?:Li\d+E)+)?", name)
        print(f"sass {short.group(0) if short else name[:70]}: {len(ops)} "
              f"instructions", flush=True)
    return out


TRACE_CHILD = r"""
import contextlib, io, json, sys
sys.path.insert(0, {root!r})
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from rmp_tpu_torch import envs
from rmp_tpu_torch.ops import cuda_tick
with contextlib.redirect_stdout(io.StringIO()):
    assert cs.main() == 0


def counts(events):
    launches = sum(1 for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    return [len(cs.device_kernels(events)), launches]


def around_calls(fn):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof.events()


out = {{}}
for scene, tag in ((cs.SCENE, "06"), (cs.SCENE05, "05")):
    env = envs.make(scene)
    k5 = cuda_tick.make_fused_qdd(env)
    near = cs.k5_inputs(env, cs.BATCH, 11, wide=False)
    ten = lambda: [k5(*near) for _ in range(10)]
    ten()
    torch.cuda.synchronize()
    rec = out[tag] = dict(around_calls=[], warm_up_step=[])
    for _ in range(3):
        rec["around_calls"] += [counts(around_calls(ten)) for _ in range(10)]
        rec["warm_up_step"] += [counts(cs.traced(ten)) for _ in range(10)]
print("RESULT", json.dumps(out))
"""


def trace_loss() -> dict:
    """K5 device kernels recorded per 10-call trace, each way (TRACE_CHILD)."""
    run = subprocess.run([sys.executable, "-c", TRACE_CHILD.format(root=ROOT)],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith("RESULT ")]
    if run.returncode != 0 or not lines:
        raise RuntimeError(f"trace child failed:\n{run.stderr}")
    out = json.loads(lines[0][len("RESULT "):])
    for tag, rec in out.items():
        for way, pairs in rec.items():
            short = sum(1 for kept, launched in pairs if kept < launched)
            print(f"traces K5 {tag} {way}: {short} of {len(pairs)} traces "
                  f"kept fewer device kernels than launch calls; kept "
                  f"{sorted(kept for kept, _ in pairs)}", flush=True)
    return out


def host_costs() -> dict:
    import torch

    import chip_smoke as cs
    from rmp_tpu_torch import _build, envs
    from rmp_tpu_torch.models import robots
    from rmp_tpu_torch.ops import cuda_fk, cuda_resolve

    _build.build()
    dev = torch.device("cuda")
    env = envs.make(cs.SCENE)
    tags, blocks = cs.real_tick_blocks(env, 16, 1)
    model = robots.franka_panda()
    q, qd = cs.k3_inputs(model, 16, dev)

    def per_call_us(fn, n: int = 2000) -> float:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return us

    out = dict(
        k1_check_and_table=per_call_us(
            lambda: cuda_resolve.block_table(tags, blocks)),
        torch_empty=per_call_us(lambda: torch.empty(16, 9, device=dev)),
        current_stream_object=per_call_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream),
        raw_stream=per_call_us(lambda: _build.raw_stream(dev)),
        k1_wrapper_b16=per_call_us(
            lambda: cuda_resolve.pullback_resolve_structured(tags, blocks)),
        k3_wrapper_b16=per_call_us(
            lambda: cuda_fk.fk_derivatives_batched(model, q, qd)))
    for k, v in out.items():
        print(f"host {k}: {v:.2f} us per call", flush=True)
    return out


def k1cta(against: str | None) -> dict:
    """Part k1cta: the split of this tree's CTA kernel (K1CTA_SPLITS) and,
    with --against DIR, of DIR's where it is the design with [A | f] in
    shared memory (K1CTA_SMEM, variants named "smem ...")."""
    out = split(K1CTA_SOURCE, K1CTA_SPLITS, only="pullback_resolve")
    if against is not None:
        out.update((f"smem {k}", v) for k, v in split(
            K1CTA_SOURCE, K1CTA_SMEM, only="pullback_resolve",
            base=against).items())
    return out


# a kernel's name and body with each source's anonymous namespace (its
# length prefix, file name and hashes) made one token, so that a kernel
# moved to another source compares as itself
ANON = re.compile(r"\d+_GLOBAL__N__[0-9a-f]{8}_\d+_\w*?_cu_[0-9a-f]{8}")


def sass_functions(lib: str) -> dict:
    """{kernel (anonymous namespaces made one token): its SASS instruction
    lines} of a built library, by cuobjdump -sass."""
    from rmp_tpu_torch import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out = {}
    for chunk in text.split("Function : ")[1:]:
        name, body = chunk.split("\n", 1)
        # cuobjdump pads a line to its listing's widest: spaces collapsed
        out[ANON.sub("ANON", name.strip())] = [
            ANON.sub("ANON", " ".join(ln.split())) for ln in body.splitlines()
            if re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln)]
    return out


def sass_against(against: str) -> dict:
    """Part sassab: every kernel of this tree's library against the kernel
    of the same name in DIR's (built from DIR's csrc/ alone): identical
    SASS, different (the unified diff into chiprun_out/sassab.txt.gz), or in
    one library only."""
    import difflib

    from rmp_tpu_torch import _build

    mine = sass_functions(_build.build())
    work = tempfile.mkdtemp()
    try:
        run = subprocess.run([sys.executable, "-c", BUILD_CHILD.format(
            root=ROOT, csrc=os.path.join(against, "rmp_tpu_torch", "csrc"),
            build=os.path.join(work, "build"))], cwd=ROOT,
            capture_output=True, text=True, timeout=900)
        if run.returncode != 0:
            return dict(error=f"build failed:\n{run.stderr[-4000:]}")
        libs = glob.glob(os.path.join(work, "build", "*", "*.so"))
        theirs = sass_functions(libs[0])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = dict(identical=[], different={},
               only_tree=sorted(set(mine) - set(theirs)),
               only_against=sorted(set(theirs) - set(mine)))
    diffs = []
    for name in sorted(set(mine) & set(theirs)):
        if mine[name] == theirs[name]:
            out["identical"].append(name)
        else:
            out["different"][name] = [len(theirs[name]), len(mine[name])]
            diffs += [f"== {name}"] + list(difflib.unified_diff(
                theirs[name], mine[name], lineterm="", n=1))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with gzip.open(os.path.join(ROOT, "chiprun_out", "sassab.txt.gz"),
                   "wt") as f:
        f.write("\n".join(diffs))
    print(f"sassab: {len(out['identical'])} kernels identical, "
          f"{len(out['different'])} different {sorted(out['different'])}, "
          f"only in this tree {out['only_tree']}, only in {against} "
          f"{out['only_against']}", flush=True)
    return out


# the parts that compare with another checkout and run only with one
NEEDS_AGAINST = ("k5ab", "k1ctaab", "sassab")


def choose_parts(args: list, against: bool, parts: list) -> tuple:
    """(the parts to run, the parts skipped) for the parts named in `args`
    (every part when none is named), `against` whether --against DIR was
    given. With no part named and no --against, the parts of NEEDS_AGAINST
    are skipped; a part named that needs --against without it, and an
    unknown part, end the run before anything is built."""
    unknown = sorted(set(args) - set(parts))
    if unknown:
        raise SystemExit(f"kernel_probe: unknown parts {unknown}; parts: "
                         f"{parts}")
    if against:
        return list(args or parts), []
    missing = [p for p in args if p in NEEDS_AGAINST]
    if missing:
        raise SystemExit(f"kernel_probe: {missing} need --against DIR")
    if args:
        return list(args), []
    return ([p for p in parts if p not in NEEDS_AGAINST],
            [p for p in parts if p in NEEDS_AGAINST])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    args = sys.argv[1:]
    against = None
    if "--against" in args:
        i = args.index("--against")
        against = os.path.abspath(args[i + 1])
        del args[i:i + 2]
    parts = dict(sass=sass_counts,
                 k3=lambda: split(K3_WIDE, only="fk_derivatives"),
                 k3narrow=lambda: split("fk_derivatives.cu",
                                        only="fk_derivatives"),
                 k3tile=lambda: split(K3_WIDE, K3_TILES,
                                      only="fk_derivatives"),
                 k3ab=lambda: medians(split(
                     K3_WIDE, K3_AB, only="fk_derivatives", rounds=K3_ROUNDS,
                     against=against, k3_all=True)),
                 k4=lambda: split("gjk_hull.cu"),
                 k1=lambda: split(K1_SOURCE, K1_SPLITS,
                                  only="pullback_resolve"),
                 k1parts=lambda: split(K1_SOURCE, K1_PARTS,
                                       only="pullback_resolve"),
                 k1ab=lambda: split(K1_SOURCE, K1_AB, only="pullback_resolve",
                                    rounds=K1_ROUNDS, against=against),
                 k1cta=lambda: k1cta(against),
                 k1ctaab=lambda: medians(split(
                     K1CTA_SOURCE, K1CTA_AB, only="pullback_resolve",
                     rounds=K1_ROUNDS, against=against), "k1ctaab"),
                 sassab=lambda: sass_against(against),
                 k5=lambda: split("fused_tick.cuh"),
                 k5wide=lambda: split(K5_WIDE, K5_WIDE_SPLITS,
                                      only="fused_tick"),
                 k5ab=lambda: medians(split(
                     K5_WIDE, K5_AB, only="fused_tick", rounds=K5_ROUNDS,
                     against=against, k3_all=True), "k5ab"),
                 host=host_costs,
                 traces=trace_loss)
    chosen, skipped = choose_parts(args, against is not None, list(parts))
    if skipped:
        print(f"kernel_probe: no --against DIR, so these parts are skipped: "
              f"{skipped}", file=sys.stderr)
    card = cs.card_lines()[0]
    print(f"card: {card}", flush=True)
    record = dict(card=card)
    record.update((name, parts[name]()) for name in chosen)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "kernel_probe.json"),
              "w") as f:
        json.dump(record, f, indent=1)
    failed = [f"{part} {name}" for part, res in record.items()
              if isinstance(res, dict) for name, v in res.items()
              if isinstance(v, dict) and "error" in v]
    if failed:
        print(f"kernel_probe: failed variants {failed}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
