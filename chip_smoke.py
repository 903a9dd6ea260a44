"""Smoke run of the PyTorch/CUDA port (rmp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the run exits non-zero without
printing the result line:
  1. card: name and power limit (nvidia-smi), torch version; needs CUDA.
  2. build: every kernel of the main path, built by nvcc from
     rmp_tpu_torch/csrc/ (seconds printed).
  3. K1 (pullback + pivoted-LU resolve) against its plain PyTorch version at
     the flagship layout and B = 4096, on seeded random blocks and on the
     blocks of a real tick; a rank-1 Gram case must stay finite. Timed with
     CUDA events beside its bound and an einsum + torch.linalg.solve
     yardstick.
  4. K2a (pullback_resolve, pullback_resolve_t; ridge 1e-6) and K2b
     (pullback_resolve_blocks; ridge 0), the dense-block entry points on
     K1's kernel, against their plain versions at B = 4096, R = 30, n = 9,
     timed beside an einsum + torch.linalg.solve yardstick.
  5. K3 (FK derivatives) against its plain version at B = 4096.
  6. K4 (GJK, link hulls vs obstacles) against its plain version at the
     flagship shapes (10 links x top-3 slots x 4096 envs, 96-vertex hulls),
     from reset states moved by q ± 0.3: a cold 10-iteration query and a
     warm 4-iteration one seeded from it. Tolerance (quantile-based, as in
     tests/test_torch_gjk.py): |Δdist| p99 < 1e-4 and median < 1e-6;
     where distances agree to 1e-5, witnesses p99 < 1e-4 and max < 5e-2;
     every output finite. Then against a float64 run of the plain version
     at 128 iterations and each pair's lower bound of its true distance
     (k4_evidence): witnesses consistent with distances, no distance below
     what the supports can reach, Minkowski points inside their balls, at
     most 0.1% of pairs parting by more than 1e-3, and the kernel (and the
     float32 plain version) at 128 iterations within 1e-4 of the float64
     distances on all but 0.1% of the pairs.
  7. main path: franka/06_cluttered_environment, 4096 envs, resolve
     'solve': 2 warm-up ticks, then a timed 150-tick rollout; every launch
     counter is zeroed just before it and read after, and each kernel of
     the path must have launched once per tick (K4 not at all). Then 10
     ticks under torch.profiler: device busy time and idle share per tick,
     device launches per tick, the kernels with most device time.
  8. hull main path: the same scene and rollout with collision_geometry
     'hull' (the reset seeds the warm carry with one cold K4 query, before
     the counters are zeroed): K1, K3 and K4 once per tick; its trace.
  9. parity: 128 envs x 5 ticks on the GPU against the same states on the
     CPU (plain versions), near the ready pose (every env) and from wider
     moves (every env whose CPU run a one-ulp move of the start leaves
     within 1e-5); and the committed golden trajectory of the flagship
     scene reproduced on the GPU.
 10. hull parity: 128 envs (broad phase, warm carry) and 8 envs (every
     pair, cold) x 5 ticks in the hull tier, GPU against CPU, from
     q ± 0.1, q̇ ± 0.05.
 11. K5 (the fused v2 tick, ops/cuda_tick.make_fused_qdd), on scenes 06
     and 05 at B = 4096: the build's registers and spills; kernel against
     plain version near the ready pose (every env) and from the wide
     states of tests/test_pallas_tick.py (envs that are finite, stable
     under a one-ulp move of q and q̇, and within 1e-5 of a float64 plain
     run), limit 2e-4 x max(1, |q̈|); kernel against the standard q̈
     (evaluate_policies, 'cholesky') on the first-capsule model, and its
     gap to the full 25-capsule model printed as a number. Timed: K5,
     its plain version and the standard q̈ evaluation it stands in for
     (FK bundle + context + blocks + K1). K5 runs on no main path: phases
     7-8 hold its count at 0. Then scene 05 GPU/CPU parity, 128 envs x 5
     ticks from q ± 0.1, q̇ ± 0.05.
Then one JSON line of per-kernel numbers ({"kernels": [...]}) and, last,
{"ok": true, "device": {...}}. The full record also goes to
chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from rmp_tpu_torch import _build, envs
from rmp_tpu_torch.core import policy_row_blocks_structured
from rmp_tpu_torch.envs.base import _policy_inputs, make_batched_control_step
from rmp_tpu_torch.models import robots
from rmp_tpu_torch.models.fk_derivatives import fk_derivatives
from rmp_tpu_torch.models import kinematics
from rmp_tpu_torch.models.urdf import FIXED
from rmp_tpu_torch.ops import (cuda_fk, cuda_gjk, cuda_resolve, cuda_tick,
                               tick_ops)
from rmp_tpu_torch.sim import collision
from rmp_tpu_torch.sim.world import SimState

ROOT = os.path.dirname(os.path.abspath(__file__))
SCENE = "franka/06_cluttered_environment"
SCENE05 = "franka/05_obstacle_avoidance"
BATCH = 4096
TICKS = 150
WARMUP_TICKS = 2
REPS = 30
# published H100 SXM peaks: HBM3 bandwidth and fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
K1_TOL = 2e-4          # max |kernel - plain| <= K1_TOL * max(1, max |q̈|)
K3_ATOL = 2e-4
K5_ACCURATE = 1e-5     # wide K5 envs compared: plain within this of float64
K4_DIST_P99, K4_DIST_MEDIAN = 1e-4, 1e-6   # |Δdist| quantiles
K4_AGREE = 1e-5        # pairs whose distances agree this well ...
# ... hold their witnesses so. The max is loose: a pair that the fixed
# iteration count leaves short of convergence, |x| above the true distance
# d*, may end anywhere within sqrt(|x|² - d*²) of the nearest point, so an
# excess of 1e-4 at 0.1 m allows 4.5e-3 (k4_evidence checks every pair
# against its own ball). The JAX package's own kernel and XLA paths part by
# 1.5e-3 over 8,960 pairs on the CPU (`python tests/test_torch_gjk.py`).
K4_WITNESS_P99, K4_WITNESS_MAX = 1e-4, 5e-2
# Where kernel and plain part, a float64 run of the plain version at
# K4_CONVERGED_ITERS iterations gives each pair a lower bound of its true
# distance (Wolfe duality, see k4_evidence); every pair must satisfy the
# bounds below, and few pairs may part by more than 1e-3.
K4_FAR, K4_FAR_SHARE = 1e-3, 1e-3
K4_CONVERGED_ITERS = 128
K4_CONVERGED_DIST = 1e-4   # kernel vs float64 plain, both converged ...
K4_CONVERGED_SHARE = 1e-3  # ... on all but this share of the pairs
K4_CERT_TOL = 1e-5         # float32 rounding slack of the bound checks
PARITY_ATOL = 1e-3     # GPU vs CPU q after 5 ticks
STABLE = 1e-5          # a one-ulp move of the start moves the CPU run less
PROFILE_TICKS = 10


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def card_lines() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def time_ms(fn, reps: int = REPS) -> float:
    """Median device time of fn() over `reps` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------- K1 ------

def k1_layout(tags, blocks):
    """(B, n, dense rows, scalar rows) of a structured block list."""
    B = blocks[0][0].shape[0]
    n = blocks[0][0].shape[-1]
    Rd = sum(b[0].shape[1] for t, b in zip(tags, blocks) if t == "dense")
    Rs = sum(b[0].shape[1] for t, b in zip(tags, blocks) if t == "scalar")
    return B, n, Rd, Rs


def k1_bound(tags, blocks):
    """Bound of the kernel call: it reads the identity seed (n² + n, summed
    over the identity blocks, absent without one), the dense rows (2n + 1
    each) and the scalar rows (n + 2 each) once and writes q̈ (n), per env;
    flops of the accumulation and the LU."""
    B, n, Rd, Rs = k1_layout(tags, blocks)
    seed = n * n + n if "identity" in tags else 0
    floats = seed + Rd * (2 * n + 1) + Rs * (n + 2) + n
    flops = (Rd * (2 * n + 2 * n * n)                    # J^T W, J^T v
             + Rs * (3 * n + n * (n + 1))                # m J, upper J^T m J
             + sum((n - k - 1) * (2 * (n - k) + 3) for k in range(n))  # LU
             + n * n + n)                                # back substitution
    return bound_ms(4.0 * floats * B, float(flops) * B)


def k1_library(tags, blocks):
    """Yardstick: einsum accumulation + torch.linalg.solve."""
    A, f = cuda_resolve.assemble_structured(tags, blocks)
    return torch.linalg.solve(A, f)


def k1_random_blocks(seed: int, B: int, device):
    """Seeded blocks in the flagship layout: a dense EE block (3 rows),
    three identity blocks with SPD metrics, the scalar obstacle block (70
    rows)."""
    rng = np.random.default_rng(seed)
    n, Rd, Rs = 9, 3, 70

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    def spd(d):
        L = rng.normal(size=(B, d, d)) * 0.3
        return L @ L.transpose(0, 2, 1) + 0.5 * np.eye(d)

    Jd = rng.normal(size=(B, Rd, n))
    blocks = [(t(Jd), t(spd(Rd) @ Jd), t(rng.normal(size=(B, Rd))))]
    for _ in range(3):
        blocks.append((t(spd(n)), t(rng.normal(size=(B, n)))))
    blocks.append((t(rng.normal(size=(B, Rs, n)) * 0.3),
                   t(rng.uniform(0.0, 2.0, (B, Rs))),
                   t(rng.normal(size=(B, Rs)))))
    return ("dense", "identity", "identity", "identity", "scalar"), blocks


def k1_compare(tags, blocks, what: str) -> float:
    got = cuda_resolve.pullback_resolve_structured(tags, blocks)
    want = cuda_resolve.pullback_resolve_structured_plain(tags, blocks)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    log(f"K1 {what}: max|kernel - plain| {err:.3e} (limit "
        f"{K1_TOL * scale:.3e}, max|q̈| {scale:.3e})")
    check(bool(torch.isfinite(got).all()), f"K1 {what}: non-finite output")
    check(err <= K1_TOL * scale, f"K1 {what}: disagrees with plain version")
    return err


def real_tick_blocks(env, B: int, seed: int):
    """Structured blocks of one real tick of the flagship scene, from
    mildly perturbed reset states (so the envs differ)."""
    rng = np.random.default_rng(seed)
    states = envs.make_batched_reset(env, B)()
    dev = states.sim.q.device
    dq = torch.tensor(rng.uniform(-0.05, 0.05, (B, 9)), dtype=torch.float32,
                      device=dev)
    dqd = torch.tensor(rng.uniform(-0.05, 0.05, (B, 9)), dtype=torch.float32,
                       device=dev)
    sim = dataclasses.replace(states.sim, q=states.sim.q + dq, qd=dqd)
    states = dataclasses.replace(states, sim=sim)
    q, qd, params, ctxs, fk = _policy_inputs(env, states, env.gather_params())
    return policy_row_blocks_structured(env.policies, q, qd, params, ctxs,
                                        fk=fk)


def phase_k1(env, device) -> dict:
    tags, blocks = k1_random_blocks(0, BATCH, device)
    err = k1_compare(tags, blocks, "random flagship layout, B=4096")
    rtags, rblocks = real_tick_blocks(env, BATCH, 1)
    check(rtags == tags, f"unexpected flagship tags {rtags}")
    err = max(err, k1_compare(rtags, rblocks, "real tick, B=4096"))

    # rank-1 Gram: env 0's scalar rows are all one vector
    rng = np.random.default_rng(2)
    n, R = 9, 9
    J = rng.normal(size=(BATCH, R, n))
    J[0] = np.outer(np.ones(R), rng.normal(size=n)) / np.sqrt(R)
    sing = ("scalar",), [tuple(torch.tensor(np.asarray(x, np.float32),
                                            device=device) for x in
                               (J, np.ones((BATCH, R)),
                                rng.normal(size=(BATCH, R))))]
    out = cuda_resolve.pullback_resolve_structured(*sing)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), "K1 rank-1 Gram: non-finite output")
    log("K1 rank-1 Gram: finite")

    ms = time_ms(lambda: cuda_resolve.pullback_resolve_structured(rtags, rblocks))
    prep_ms = time_ms(lambda: cuda_resolve.kernel_inputs(rtags, rblocks))
    plain_ms = time_ms(
        lambda: cuda_resolve.pullback_resolve_structured_plain(rtags, rblocks))
    library_ms = time_ms(lambda: k1_library(rtags, rblocks))
    b_ms, b_by = k1_bound(rtags, rblocks)
    log(f"K1 times at B=4096: kernel {ms:.4f} ms (of which operand "
        f"preparation {prep_ms:.4f} ms), plain {plain_ms:.4f} ms, "
        f"einsum+linalg.solve {library_ms:.4f} ms, bound {b_ms:.5f} ms "
        f"({b_by})")
    return dict(name="pullback_resolve_structured", route="cuda",
                source="rmp_tpu_torch/csrc/pullback_resolve.cu",
                replaces="rmp_tpu/ops/pallas_resolve.py:226",
                max_abs_err=err, ms=ms, kernel_ms=ms, prep_ms=prep_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)


# ---------------------------------------------------------- K2a, K2b -----

def k2_rows(seed: int, B: int, R: int = 30, n: int = 9, device=None):
    """J (B, R, n), W = diag(m) J, v (B, R): the layout of
    tests/test_pallas_resolve.py."""
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(B, R, n))
    W = J * rng.uniform(0.1, 2.0, (B, R, 1))
    return tuple(torch.tensor(np.asarray(x, np.float32), device=device)
                 for x in (J, W, rng.normal(size=(B, R))))


def k2_compare(got, want, what: str) -> float:
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    log(f"{what}: max|kernel - plain| {err:.3e} (limit {K1_TOL * scale:.3e})")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check(err <= K1_TOL * scale, f"{what}: disagrees with plain version")
    return err


def phase_k2(device) -> tuple[dict, dict]:
    J, W, v = k2_rows(5, BATCH, device=device)
    Jt, Wt, vt = (x.permute(*reversed(range(x.dim()))).contiguous()
                  for x in (J, W, v))
    err_a = max(
        k2_compare(cuda_resolve.pullback_resolve(J, W, v),
                   cuda_resolve.pullback_resolve_plain(J, W, v),
                   "K2a pullback_resolve, ridge 1e-6"),
        k2_compare(cuda_resolve.pullback_resolve_t(Jt, Wt, vt),
                   cuda_resolve.pullback_resolve_t_plain(Jt, Wt, vt),
                   "K2a pullback_resolve_t, ridge 1e-6"))
    cuts = ((0, 3), (3, 23), (23, 30))
    Js, Ws, vs = ([x[:, a:b] for a, b in cuts] for x in (J, W, v))
    err_b = k2_compare(cuda_resolve.pullback_resolve_blocks(Js, Ws, vs),
                       cuda_resolve.pullback_resolve_blocks_plain(Js, Ws, vs),
                       "K2b pullback_resolve_blocks (3 blocks), ridge 0")
    b_ms, b_by = k1_bound(("dense",), [(J, W, v)])

    def library():
        A = torch.einsum("brn,brm->bnm", J, W)
        A = A + 1e-6 * torch.eye(A.shape[-1], device=device)
        return torch.linalg.solve(A, torch.einsum("brn,br->bn", J, v))

    library_ms = time_ms(library)
    recs = []
    for name, fn, plain, src_line, err in (
            ("pullback_resolve", lambda: cuda_resolve.pullback_resolve(J, W, v),
             lambda: cuda_resolve.pullback_resolve_plain(J, W, v), 120, err_a),
            ("pullback_resolve_blocks",
             lambda: cuda_resolve.pullback_resolve_blocks(Js, Ws, vs),
             lambda: cuda_resolve.pullback_resolve_blocks_plain(Js, Ws, vs),
             312, err_b)):
        ms, plain_ms = time_ms(fn), time_ms(plain)
        log(f"{name} times at B={BATCH}, R=30: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, einsum+linalg.solve {library_ms:.4f} ms, "
            f"bound {b_ms:.5f} ms ({b_by})")
        recs.append(dict(name=name, route="cuda",
                         source="rmp_tpu_torch/csrc/pullback_resolve.cu",
                         replaces=f"rmp_tpu/ops/pallas_resolve.py:{src_line}",
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=library_ms))
    recs[0]["t_ms"] = time_ms(lambda: cuda_resolve.pullback_resolve_t(Jt, Wt,
                                                                       vt))
    return recs[0], recs[1]


# ---------------------------------------------------------------- K3 ------

def k3_bound(model, B: int):
    """Bound of the kernel: reads q, qd and writes T, Td, c (16 floats
    each) and J (16 n) per frame, once; flops of its 4x4 products
    (112 flops each) and element-wise updates."""
    n, F = model.n_q, model.n_frames
    floats = 2 * n + F * 16 * (3 + n)
    mm = 112
    flops = 0
    for f in range(F):
        flops += 2 * mm + mm + (2 * mm + 16)       # A, T; Td; c
        if model.joint_type[f] != FIXED:
            flops += 2 * mm + 18 + 32 + 2 * mm + 48  # G, inverse, W, Wd
        flops += mm * sum(1 for j in model.chain(f)
                          if model.joint_type[j] != FIXED)
    return bound_ms(4.0 * floats * B, float(flops) * B)


def phase_k3(device) -> dict:
    model = robots.franka_panda()
    rng = np.random.default_rng(3)
    q = torch.tensor(rng.uniform(-1.2, 1.2, (BATCH, model.n_q)),
                     dtype=torch.float32, device=device)
    qd = torch.tensor(rng.uniform(-1.0, 1.0, (BATCH, model.n_q)),
                      dtype=torch.float32, device=device)
    got = cuda_fk.fk_derivatives_batched(model, q, qd)
    want = fk_derivatives(model, q, qd)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, w in zip(("T16", "Td16", "J16", "c16"), got, want):
        check(g.shape == w.shape, f"K3 {name}: shape {g.shape} vs {w.shape}")
        e = float((g - w).abs().max())
        log(f"K3 {name}: max|kernel - plain| {e:.3e} (atol {K3_ATOL})")
        check(e <= K3_ATOL, f"K3 {name}: disagrees with plain version")
        err = max(err, e)
    ms = time_ms(lambda: cuda_fk.fk_derivatives_batched(model, q, qd))
    plain_ms = time_ms(lambda: fk_derivatives(model, q, qd))
    b_ms, b_by = k3_bound(model, BATCH)
    log(f"K3 times at B=4096: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.5f} ms ({b_by})")
    return dict(name="fk_derivatives_batched", route="cuda",
                source="rmp_tpu_torch/csrc/fk_derivatives.cu",
                replaces="rmp_tpu/ops/pallas_fk.py:218",
                max_abs_err=err, ms=ms, kernel_ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


# ---------------------------------------------------------------- K4 ------

K4_SUPPORT_VERTEX_FLOPS = 10   # dot (3 mul, 2 add), compare, 4 accumulates
K4_SUPPORT_FIXED_FLOPS = 37    # R^T d, 1 / count and scale, R s + t
K4_OBSTACLE_FLOPS = 50         # both obstacle supports and the select
K4_JOHNSON_NEWEST_FLOPS = 470  # Gram 50, 1 single, 3 pairs, 3 triples, tet
K4_JOHNSON_FULL_FLOPS = 650    # Gram 50, 4 singles, 6 pairs, 4 triples, tet
K4_STEP_FLOPS = 30             # gap test, eviction and slot selects


def k4_bound(ops: dict, iters: int):
    """Bound of one K4 call: reads the hull tables, each (link, env) pose
    (12 floats) and each pair's operands (14 floats) once and writes 7
    floats per pair; flops per pair by the counts above (the kernel runs
    every iteration, frozen pairs too)."""
    L, V, _ = ops["verts"].shape
    M, B = ops["p0"].shape[1], ops["p0"].shape[3]
    pairs = L * M * B
    hull = K4_SUPPORT_VERTEX_FLOPS * V + K4_SUPPORT_FIXED_FLOPS
    per_pair = (hull + K4_OBSTACLE_FLOPS
                + iters * (K4_JOHNSON_NEWEST_FLOPS + hull + K4_OBSTACLE_FLOPS
                           + K4_STEP_FLOPS)
                + K4_JOHNSON_FULL_FLOPS + 30)
    floats = L * V * 3 + L * B * 12 + pairs * (14 + 7)
    return bound_ms(4.0 * floats, float(per_pair) * pairs)


def k4_compare(got, want, what: str) -> dict:
    """Quantile agreement of K4 outputs (pa, pb, dist) with the plain
    version's."""
    torch.cuda.synchronize()
    for g in got:
        check(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
    diff = (got[2] - want[2]).abs().flatten().double()
    q99, med = float(diff.quantile(0.99)), float(diff.median())
    agree = (got[2] - want[2]).abs() < K4_AGREE
    werr = torch.cat([(g - w).abs().amax(dim=2)[agree]
                      for g, w in zip(got[:2], want[:2])]).double()
    rec = dict(dist_p99=q99, dist_median=med, dist_max=float(diff.max()),
               agree_share=float(agree.float().mean()),
               witness_p99=float(werr.quantile(0.99)),
               witness_max=float(werr.max()))
    log(f"{what}: {json.dumps(rec)}")
    check(q99 < K4_DIST_P99 and med < K4_DIST_MEDIAN,
          f"{what}: distances disagree with the plain version")
    check(rec["witness_p99"] < K4_WITNESS_P99
          and rec["witness_max"] < K4_WITNESS_MAX,
          f"{what}: witnesses disagree with the plain version")
    return rec


def pairs_last(x):
    """(L, M, 3, B) -> (L, M, B, 3), in float64."""
    return x.permute(0, 1, 3, 2).double()


def k4_lower_bound(ops, pa, pb):
    """(x, lower, reach) per pair from a witness pair (L, M, 3, B), in
    float64 and apart from the port's GJK code: the Minkowski point
    x = pa - pb (L, M, B, 3) and min over y in A - B of <x, y> / |x| (A the
    posed hull, B the obstacle), which no distance between the sets is below
    (Wolfe duality); 0 where x = 0. `lower` takes B as it is: the capsule,
    or the flat-capped cylinder on p0 -> p1. `reach` takes every cylinder as
    the capsule on the same segment and radius: the cylinder support of the
    GJK (end + r d_perp / (|d_perp| + 1e-12)) returns points within it even
    where rounding swamps d_perp. The support values are exact: max over the
    posed vertices; max(<d, p0>, <d, p1>) + r |d| for a capsule,
    + r |d - (d.a)a| for a cylinder of unit axis a."""
    x = pairs_last(pa - pb)
    R, t, verts = ops["R"].double(), ops["t"].double(), ops["verts"].double()
    posed = (torch.einsum("lijb,lvj->lbvi", R, verts)
             + t.permute(0, 2, 1)[:, :, None])                 # (L, B, V, 3)
    h_link = torch.einsum("lmbi,lbvi->lmbv", -x, posed).amax(dim=-1)
    p0, p1 = pairs_last(ops["p0"]), pairs_last(ops["p1"])
    axis = p1 - p0
    length = torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    a = axis / torch.where(length > 0, length, torch.ones_like(length))
    n2 = (x * x).sum(-1)
    n = n2.sqrt()
    perp = (n2 - (x * a).sum(-1) ** 2).clamp_min(0.0).sqrt()
    ends = torch.maximum((x * p0).sum(-1), (x * p1).sum(-1))
    r = ops["radius"][:, :, 0].double()
    n_safe = torch.where(n > 0, n, torch.ones_like(n))

    def bound(spread):
        return ((-h_link - ends - r * spread) / n_safe).clamp_min(0.0)
    return (x, bound(torch.where(ops["is_cyl"][:, :, 0] > 0.5, perp, n)),
            bound(n))


def k4_evidence(ops, got, plain, what: str) -> dict:
    """Which of two parting answers is right, pair by pair, held against
    bounds of the true distance. A float64 run of the plain version at
    K4_CONVERGED_ITERS iterations gives x_ref; k4_lower_bound of it gives
    `lo` <= the true distance d* and `reach` <= the distance to the
    capsules the GJK's supports can reach. The kernel and the float32 plain
    version also run K4_CONVERGED_ITERS iterations (conv, conv_plain). The
    checks cover the pairs whose hull answer the path uses, those beyond the
    0.5 mm handoff (below it the capsule query's answer is taken; there the
    final Johnson solve may report contact, x = 0, from a tetrahedron that
    holds the origin within its feasibility slack). Pairs where an answer
    falls below lo are off-shape: a support point left the cylinder (an
    iterate along its axis, whose d_perp rounding swamps); only a cylinder
    pair can be. For the kernel's answer (x, dist) at the path's iteration
    count, and the plain version's:
      - |pa - pb| equals dist (the witnesses are the distance's);
      - dist >= reach on every pair;
      - on the other pairs |x - x_ref| <= r(x) + r(x_ref),
        r(y) = sqrt((|y| + tol)² - lo²): every y in the convex A - B has
        |y - x*|² <= |y|² - d*², x* its point nearest the origin (tol for
        float32 rounding of |y|);
      - the share of pairs where kernel and plain part by more than K4_FAR
        stays within K4_FAR_SHARE;
      - the share of pairs where conv, and conv_plain, stay more than
        K4_CONVERGED_DIST from the reference stays within
        K4_CONVERGED_SHARE: the float32 algorithm stalls on a few pairs,
        or leaves the cylinder.
    On the tail (pairs whose distances part by more than 1e-4, or whose
    witnesses part by more than 1e-4 where the distances agree) it reports
    how many are off-shape, how far each answer stands above lo, and how
    far the Minkowski points and the witnesses part."""
    contact, tol = collision.HULL_CONTACT, K4_CERT_TOL
    ops64 = {k: v.double() for k, v in ops.items()}
    ref = cuda_gjk.gjk_hull_obstacles_plain(**ops64,
                                            iters=K4_CONVERGED_ITERS)
    conv = cuda_gjk.gjk_hull_obstacles(**ops, iters=K4_CONVERGED_ITERS)
    conv_plain = cuda_gjk.gjk_hull_obstacles_plain(**ops,
                                                   iters=K4_CONVERGED_ITERS)
    x_ref, lo, reach = k4_lower_bound(ops, *ref[:2])
    x_k = k4_lower_bound(ops, *got[:2])[0]
    x_p = k4_lower_bound(ops, *plain[:2])[0]
    x_c = k4_lower_bound(ops, *conv[:2])[0]
    d_ref, d_k, d_p, d_c, d_cp = (o[2].double() for o in
                                  (ref, got, plain, conv, conv_plain))
    used = (d_k > contact) & (d_p > contact) & (d_ref > contact)
    off = used & ((lo - d_k > tol) | (lo - d_p > tol) | (lo - d_c > tol))
    on = used & ~off
    cyl = ops["is_cyl"][:, :, 0] > 0.5
    p0, p1 = pairs_last(ops["p0"]), pairs_last(ops["p1"])
    axis_cos = ((x_ref * (p1 - p0)).sum(-1).abs()
                / (torch.linalg.vector_norm(x_ref, dim=-1)
                   * torch.linalg.vector_norm(p1 - p0, dim=-1)
                   ).clamp_min(1e-30))

    def r(d):
        return ((d + tol) ** 2 - lo * lo).clamp_min(0.0).sqrt()

    def norm(v):
        return torch.linalg.vector_norm(v, dim=-1)

    def wdiff(a, b):
        return torch.maximum((a[0].double() - b[0].double()).abs().amax(2),
                             (a[1].double() - b[1].double()).abs().amax(2))

    def umax(v, where=used):
        return float(v[where].max()) if bool(where.any()) else 0.0

    def umin(v, where=used):
        return float(v[where].min()) if bool(where.any()) else 0.0

    ddist = (d_k - d_p).abs()
    wit = wdiff(got, plain)
    tail = used & ((ddist > 1e-4) | ((ddist < K4_AGREE) & (wit > 1e-4)))
    apart = used & ((d_c - d_ref).abs() > K4_CONVERGED_DIST)
    apart_plain = used & ((d_cp - d_ref).abs() > K4_CONVERGED_DIST)
    n_used = max(int(used.sum()), 1)
    rec = dict(
        pairs_checked=int(used.sum()),
        witness_vs_dist=max(umax((norm(x_k) - d_k).abs()),
                            umax((norm(x_p) - d_p).abs())),
        below_reach=max(umax(reach - d_k), umax(reach - d_p),
                        umax(reach - d_c)),
        ref_below_lo=umax(lo - d_ref),
        ref_width_max=umax(d_ref - lo),
        ref_width_p99=float((d_ref - lo)[used].quantile(0.99)),
        off_shape_pairs=int(off.sum()),
        off_shape_not_cylinder=int((off & ~cyl).sum()),
        off_shape_axis_cos_min=umin(axis_cos, off),
        off_shape_below_lo_kernel=umax(lo - d_k, off),
        off_shape_below_lo_plain=umax(lo - d_p, off),
        off_shape_below_lo_converged=umax(lo - d_c, off),
        ball_excess=umax(norm(x_k - x_ref) - r(d_k) - r(d_ref), on),
        far_share=float((ddist > K4_FAR).double().mean()),
        far_pairs=int((ddist > K4_FAR).sum()),
        far_off_shape=int((off & (ddist > K4_FAR)).sum()),
        tail_pairs=int(tail.sum()),
        tail_off_shape=int((tail & off).sum()),
        tail_above_lo_kernel=umax(d_k - lo, tail & on),
        tail_above_lo_plain=umax(d_p - lo, tail & on),
        tail_dx=umax(norm(x_k - x_p), tail & on),
        tail_dwitness=umax(wit, tail & on),
        converged_apart_share=int(apart.sum()) / n_used,
        converged_apart_pairs=int(apart.sum()),
        converged_apart_off_shape=int((apart & off).sum()),
        converged_apart_cylinder=int((apart & cyl).sum()),
        converged_apart_max=umax((d_c - d_ref).abs()),
        converged_plain_apart_pairs=int(apart_plain.sum()),
        converged_plain_apart_max=umax((d_cp - d_ref).abs()),
        converged_dist_max_other=umax((d_c - d_ref).abs(), on & ~apart),
        tail_converged_dist=umax((d_c - d_ref).abs(), tail & ~apart),
        tail_converged_dx=umax(norm(x_c - x_ref), tail & ~apart),
        tail_converged_dwitness=umax(wdiff(conv, ref), tail & ~apart))
    log(f"{what} against float64 at {K4_CONVERGED_ITERS} iterations: "
        f"{json.dumps(rec)}")
    check(rec["witness_vs_dist"] <= tol,
          f"{what}: |pa - pb| differs from dist")
    check(rec["below_reach"] <= tol,
          f"{what}: a distance falls below what the supports can reach")
    check(rec["off_shape_not_cylinder"] == 0,
          f"{what}: a capsule pair falls below its lower bound")
    check(rec["ball_excess"] <= tol,
          f"{what}: a Minkowski point lies outside its ball around x*")
    check(rec["far_share"] <= K4_FAR_SHARE,
          f"{what}: too many pairs part by more than {K4_FAR}")
    check(max(int(apart.sum()), int(apart_plain.sum())) / n_used
          <= K4_CONVERGED_SHARE,
          f"{what}: too many pairs stay apart from the float64 reference")
    return rec


def phase_k4(env, device) -> dict:
    model = env.model
    states = perturbed_states(env, BATCH, 6, 0.3, 0.0)
    T_all = kinematics.fk_all(model, states.sim.q)
    obstacles = states.sim.obstacles
    cap = collision.robot_obstacle_distances(model, T_all, obstacles)
    _, cold_ops = collision.gjk_operands(model, T_all, obstacles, cap)
    *_, dist, warm = collision.robot_obstacle_distances_hull_batched(
        model, T_all, obstacles)
    near = int((dist <= collision.HULL_CONTACT).sum())
    log(f"K4 inputs: {near} of {dist.numel()} pairs within the 0.5 mm "
        f"handoff")
    check(near > 0, "K4 inputs: no pair reaches the near-contact handoff")
    _, warm_ops = collision.gjk_operands(model, T_all, obstacles, cap,
                                         warm=warm)
    out = {}
    for mode, ops, iters in (("cold", cold_ops, 10), ("warm", warm_ops, 4)):
        run = lambda: cuda_gjk.gjk_hull_obstacles(**ops, iters=iters)  # noqa: E731
        plain = lambda: cuda_gjk.gjk_hull_obstacles_plain(**ops, iters=iters)  # noqa: E731
        got, want = run(), plain()
        rec = k4_compare(got, want, f"K4 {mode} {iters} iterations")
        rec["evidence"] = k4_evidence(ops, got, want,
                                      f"K4 {mode} {iters} iterations")
        rec["ms"] = time_ms(run)
        rec["plain_ms"] = time_ms(plain, reps=5)
        rec["bound_ms"], rec["bound_by"] = k4_bound(ops, iters)
        log(f"K4 {mode} times at {tuple(ops['p0'].shape[:2])} x {BATCH} "
            f"pairs: kernel "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
            f"{rec['bound_ms']:.5f} ms ({rec['bound_by']})")
        out[mode] = rec
    # the main path's per-tick call is the warm one
    w = out["warm"]
    return dict(name="gjk_hull_obstacles", route="cuda",
                source="rmp_tpu_torch/csrc/gjk_hull.cu",
                replaces="rmp_tpu/ops/pallas_gjk.py:318",
                max_abs_err=max(out["cold"]["dist_max"], w["dist_max"]),
                ms=w["ms"], plain_ms=w["plain_ms"], bound_ms=w["bound_ms"],
                bound_by=w["bound_by"], library_ms=None, cold=out["cold"],
                warm=w)


# ---------------------------------------------------------------- K5 ------

def k5_bound(tick, B: int, K: int):
    """Bound of one K5 call: reads q, q̇ (n each), the goal (3) and the
    obstacles (7 K) once and writes q̈ (n), per env; per env it does the
    operations of the reference body with its constant folding, less those
    of A's mirrored upper triangle (tick_ops.fused_qdd_ops)."""
    n = tick.model.n_q
    total, mirrored = tick_ops.fused_qdd_ops(tick, K)
    return bound_ms(4.0 * B * (3 * n + 3 + 7 * K),
                    float(total - mirrored) * B)


def k5_inputs(env, B: int, seed: int, wide: bool, dtype=torch.float32):
    """(q, q̇, goal, obs_p0, obs_p1, obs_r) on the card: near the ready pose
    (reset q ± 0.1, q̇ ± 0.05, goal ± 0.05) or the wide states of
    tests/test_pallas_tick.py (q ± 1, q̇ ± 0.8, goals in its box)."""
    rng = np.random.default_rng(seed)
    start = envs.make_batched_reset(env, B)().sim
    if wide:
        q = rng.uniform(-1.0, 1.0, (B, 9))
        qd = rng.uniform(-0.8, 0.8, (B, 9))
        goal = rng.uniform([0.2, -0.5, 0.2], [0.7, 0.5, 0.7], (B, 3))
    else:
        q = start.q.cpu().numpy() + rng.uniform(-0.1, 0.1, (B, 9))
        qd = rng.uniform(-0.05, 0.05, (B, 9))
        goal = start.goal.cpu().numpy() + rng.uniform(-0.05, 0.05, (B, 3))
    dev = start.q.device
    obs = start.obstacles
    return tuple(torch.tensor(np.asarray(x, np.float32), device=dev).to(dtype)
                 for x in (q, qd, goal)) + tuple(
        x.contiguous().to(dtype) for x in (obs.p0, obs.p1, obs.radius))


def k5_rel(got, want) -> torch.Tensor:
    """Per env max |got - want| / max(1, max |want|)."""
    scale = want.abs().amax(dim=1).clamp_min(1.0)
    return (got - want).abs().amax(dim=1) / scale


def ptxas_counts(source: str) -> dict:
    """Registers, stack frame and spill bytes of `source` from build.log."""
    text = _build.build_log().split(f"== {source}\n", 1)[-1].split("\n== ")[0]

    def num(pattern):
        found = re.findall(pattern, text)
        return max(int(v) for v in found) if found else None
    return dict(registers=num(r"Used (\d+) registers"),
                stack_bytes=num(r"(\d+) bytes stack frame"),
                spill_store_bytes=num(r"(\d+) bytes spill stores"),
                spill_load_bytes=num(r"(\d+) bytes spill loads"))


def k5_check(what: str, err: torch.Tensor, limit: float) -> float:
    worst = float(err.max())
    log(f"K5 {what}: max|Δq̈| / max(1, |q̈|) {worst:.3e} (limit {limit})")
    check(worst <= limit, f"K5 {what}: disagrees")
    return worst


def phase_k5(device) -> dict:
    build = ptxas_counts("fused_tick.cu")
    log(f"K5 build (fused_tick.cu): {json.dumps(build)}")
    check(build["registers"] is not None, "K5: no ptxas line in build.log")
    rec = dict(name="fused_qdd", route="cuda",
               source="rmp_tpu_torch/csrc/fused_tick.cu",
               replaces="rmp_tpu/ops/pallas_tick.py:421", build=build)
    err = 0.0
    for scene, tag in ((SCENE, "06"), (SCENE05, "05")):
        env = envs.make(scene)
        tick = cuda_tick.fused_tick(env)
        fn = cuda_tick.make_fused_qdd(env)
        plain = functools.partial(cuda_tick.fused_qdd_plain, tick)
        near = k5_inputs(env, BATCH, 11, wide=False)
        got, want = fn(*near), plain(*near)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K5 {tag}: non-finite")
        err = max(err, k5_check(f"{tag} near ready, kernel vs plain, "
                                f"{BATCH} envs", k5_rel(got, want), K1_TOL))

        wide = k5_inputs(env, BATCH, 13, wide=True)
        up = torch.tensor(float("inf"), device=device)
        w_got, w_want = fn(*wide), plain(*wide)
        w_ulp = plain(torch.nextafter(wide[0], up),
                      torch.nextafter(wide[1], up), *wide[2:])
        w_64 = plain(*(x.double() for x in wide))
        finite = torch.isfinite(w_want).all(dim=1)
        w0 = torch.nan_to_num(w_want)
        held = (finite & (k5_rel(w_ulp, w0) <= STABLE)
                & (k5_rel(w_64, w0.double()) <= K5_ACCURATE))
        n_held = int(held.sum())
        log(f"K5 {tag} wide: {int(finite.sum())} of {BATCH} envs finite, "
            f"{n_held} compared")
        check(n_held >= BATCH // 2, f"K5 {tag} wide: too few envs compared")
        err = max(err, k5_check(f"{tag} wide, kernel vs plain",
                                k5_rel(w_got[held], w_want[held]), K1_TOL))

        first = cuda_tick.standard_qdd(env, *near, first_capsule=True)
        full = cuda_tick.standard_qdd(env, *near, first_capsule=False)
        k5_check(f"{tag} kernel vs the standard q̈ on first capsules",
                 k5_rel(got, first), K1_TOL)
        gap = float((got - full).abs().max())
        log(f"K5 {tag}: max|q̈_K5 - q̈_standard| on the full 25-capsule "
            f"model {gap:.3e} (K5 reads each link's first capsule only)")

        params = env.gather_params()
        states = dataclasses.replace(
            envs.make_batched_reset(env, BATCH)(), sim=SimState(
                q=near[0], qd=near[1], t=torch.zeros_like(near[0][:, 0]),
                obstacles=collision.ObstacleSet(*near[3:]), goal=near[2]))

        def standard():
            q, qd, prm, ctxs, fk = _policy_inputs(env, states, params)
            tags, blocks = policy_row_blocks_structured(
                env.policies, q, qd, prm, ctxs, fk=fk)
            return cuda_resolve.pullback_resolve_structured(tags, blocks,
                                                            ridge=0.0)

        K = near[5].shape[1]
        times = dict(ms=time_ms(lambda: fn(*near)),
                     plain_ms=time_ms(lambda: plain(*near), reps=5),
                     standard_ms=time_ms(standard))
        b_ms, b_by = k5_bound(tick, BATCH, K)
        total, mirrored = tick_ops.fused_qdd_ops(tick, K)
        log(f"K5 {tag} times at B={BATCH}, K={K}: kernel {times['ms']:.4f} "
            f"ms, plain {times['plain_ms']:.4f} ms, standard q̈ evaluation "
            f"(FK + context + blocks + K1) {times['standard_ms']:.4f} ms, "
            f"bound {b_ms:.6f} ms ({b_by}, {total - mirrored} operations "
            f"per env: the reference body's {total} less {mirrored} on A's "
            f"mirrored upper triangle)")
        rec[f"scene{tag}"] = dict(
            K=K, wide_compared=n_held, full_model_gap=gap, bound_ms=b_ms,
            bound_by=b_by, ops_per_env=total - mirrored,
            reference_ops_per_env=total, **times)
    main = rec["scene06"]
    # no single PyTorch call computes the fused tick
    rec.update(max_abs_err=err, ms=main["ms"], plain_ms=main["plain_ms"],
               bound_ms=main["bound_ms"], bound_by=main["bound_by"],
               library_ms=None)
    return rec


# ---------------------------------------------------------- main path -----

COUNTERS = {
    "pullback_resolve_structured": cuda_resolve.pullback_resolve_structured,
    "pullback_resolve": cuda_resolve.pullback_resolve,
    "pullback_resolve_t": cuda_resolve.pullback_resolve_t,
    "pullback_resolve_blocks": cuda_resolve.pullback_resolve_blocks,
    "fk_derivatives_batched": cuda_fk.fk_derivatives_batched,
    "gjk_hull_obstacles": cuda_gjk.gjk_hull_obstacles,
    "fused_qdd": cuda_tick.fused_qdd,
}
# the kernels each main path runs once per tick; every other counter (K2a,
# K2b, K5) stays 0
PATH_KERNELS = {
    "capsule": ("pullback_resolve_structured", "fk_derivatives_batched"),
    "hull": ("pullback_resolve_structured", "fk_derivatives_batched",
             "gjk_hull_obstacles"),
}


def phase_main_path(card: str, geometry: str) -> tuple[dict, dict]:
    what = "main path" if geometry == "capsule" else "hull main path"
    env = envs.make(SCENE)                   # the GPU by default
    env.resolve_method = "solve"
    env.collision_geometry = geometry
    params = env.gather_params()
    states = envs.make_batched_reset(env, BATCH)()
    states, _ = envs.make_batched_rollout(env, WARMUP_TICKS,
                                          with_aux=False)(states, params)
    rollout = envs.make_batched_rollout(env, TICKS, with_aux=False)
    torch.cuda.synchronize()
    for fn in COUNTERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    final, _ = rollout(states, params)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    steps_per_s = BATCH * TICKS / seconds
    log(f"{what}: {SCENE} ({geometry}), {BATCH} envs x {TICKS} ticks in "
        f"{seconds:.3f} s = {steps_per_s:.1f} control steps/s [{card}]")
    log(f"{what} launches: {launches}")
    check(bool(torch.isfinite(final.sim.q).all()), f"{what}: non-finite q")
    check(tuple(final.sim.q.shape) == (BATCH, 9), f"{what}: q shape")
    for name, count in launches.items():
        want = TICKS if name in PATH_KERNELS[geometry] else 0
        check(count == want, f"{what}: {name} launched {count} times in "
              f"{TICKS} ticks, want {want}")
    solved = int(final.solved_count.sum())
    log(f"{what}: goals reached over the batch {solved}, "
        f"mean phase {float(final.phase.float().mean()):.3f}")
    trace = profile_ticks(env, final, params, seconds * 1e3 / TICKS)
    log(f"{what} trace: {json.dumps(trace)}")
    return launches, dict(geometry=geometry, envs=BATCH, ticks=TICKS,
                          seconds=seconds, control_steps_per_s=steps_per_s,
                          goals_reached=solved, trace=trace)


def _busy_us(events) -> float:
    """Length of the union of the device kernel intervals, in us."""
    busy, cur_start, cur_end = 0.0, None, None
    for start, end in sorted((e.time_range.start, e.time_range.end)
                             for e in events):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_start
    return busy


def profile_ticks(env, states, params, tick_ms: float) -> dict:
    """PROFILE_TICKS ticks under torch.profiler: device busy ms per tick
    (union of kernel intervals), the idle share of the unprofiled tick
    (tick_ms) and of the traced span (which the profiler stretches), device
    launches per tick, the port's own kernels' device time, and the
    kernels with the most device time."""
    step = envs.make_batched_control_step(env)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_TICKS):
            states, _ = step(states, params)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    check(bool(kernels), "main path trace: no device activity recorded")
    by_name: dict[str, list] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    top = sorted(((sum(v), len(v), k) for k, v in by_name.items()),
                 reverse=True)[:10]
    busy_ms = _busy_us(kernels) / 1e3 / PROFILE_TICKS
    span_ms = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels)) / 1e3 / PROFILE_TICKS
    return dict(
        ticks=PROFILE_TICKS, tick_ms=tick_ms,
        device_launches_per_tick=len(kernels) / PROFILE_TICKS,
        device_busy_ms_per_tick=busy_ms,
        device_idle_share=1.0 - busy_ms / tick_ms,
        device_idle_share_traced=1.0 - busy_ms / span_ms,
        port_kernels_us_per_tick={
            k[:60]: sum(v) / PROFILE_TICKS for k, v in by_name.items()
            if any(n in k for n in ("pullback_resolve_kernel",
                                    "fk_derivatives_kernel",
                                    "gjk_hull_kernel"))},
        top_kernels=[dict(name=k[:80], us_per_tick=t / PROFILE_TICKS,
                          launches_per_tick=c / PROFILE_TICKS)
                     for t, c, k in top])


def perturbed_states(env, B: int, seed: int, dq: float, dqd: float,
                     ulp: bool = False):
    """Reset states moved by q ± dq, q̇ ± dqd (seeded); with ulp, q and q̇
    then move up by one ulp."""
    rng = np.random.default_rng(seed)
    states = envs.make_batched_reset(env, B)()
    dev = states.sim.q.device
    q = states.sim.q + torch.tensor(rng.uniform(-dq, dq, (B, 9)),
                                    dtype=torch.float32, device=dev)
    qd = torch.tensor(rng.uniform(-dqd, dqd, (B, 9)), dtype=torch.float32,
                      device=dev)
    if ulp:
        up = torch.tensor(float("inf"), device=dev)
        q, qd = torch.nextafter(q, up), torch.nextafter(qd, up)
    return dataclasses.replace(states, sim=dataclasses.replace(
        states.sim, q=q, qd=qd))


def parity_q(dev: str, dq: float, dqd: float, ulp: bool = False,
             geometry: str = "capsule", B: int = 128, scene: str = SCENE):
    env = envs.make(scene, device=dev)
    env.resolve_method = "solve"
    env.collision_geometry = geometry
    final, _ = envs.make_batched_rollout(env, 5, with_aux=False)(
        perturbed_states(env, B, 4, dq, dqd, ulp), env.gather_params())
    return final.sim.q.cpu()


def phase_parity() -> dict:
    # near the ready pose every env is well conditioned
    err = float((parity_q("cuda", 0.1, 0.05)
                 - parity_q("cpu", 0.1, 0.05)).abs().max())
    log(f"parity: 128 envs x 5 ticks from q ± 0.1, q̇ ± 0.05, "
        f"max|q_gpu - q_cpu| {err:.3e} (atol {PARITY_ATOL})")
    check(err <= PARITY_ATOL, "GPU/CPU parity")

    # from q ± 0.3, q̇ ± 0.5 envs that reach the velocity cap's clip amplify
    # rounding (tests/test_torch_conditioning.py): held where the CPU run
    # itself is insensitive to a one-ulp move of its start
    cpu = parity_q("cpu", 0.3, 0.5)
    sens = (parity_q("cpu", 0.3, 0.5, ulp=True) - cpu).abs().amax(dim=1)
    gap = (parity_q("cuda", 0.3, 0.5) - cpu).abs().amax(dim=1)
    stable = sens <= STABLE
    wide = dict(stable_envs=int(stable.sum()),
                max_gap_stable=float(gap[stable].max()),
                max_gap_unstable=float(gap[~stable].max()) if
                bool((~stable).any()) else None,
                max_sensitivity=float(sens.max()))
    log(f"parity: 128 envs x 5 ticks from q ± 0.3, q̇ ± 0.5: {json.dumps(wide)}"
        f" (atol {PARITY_ATOL} on the stable envs)")
    check(wide["stable_envs"] >= 64, "wide parity: too few stable envs")
    check(wide["max_gap_stable"] <= PARITY_ATOL, "wide GPU/CPU parity")

    # committed golden trajectory of the flagship scene (B = 1, no resample)
    data = np.load(os.path.join(ROOT, "tests", "golden",
                                "franka06_cluttered_trajectory.npz"))
    env = envs.make(SCENE)
    env.resolve_method = "solve"
    env.on_solved = None
    step = make_batched_control_step(env)
    params = env.gather_params()
    state = envs.make_batched_reset(env, 1)()
    traj, qdd0 = [state.sim.q[0].cpu().numpy()], None
    for _ in range(data["qdd"].shape[0]):
        state, aux = step(state, params)
        if qdd0 is None:
            qdd0 = aux["qdd"][0].cpu().numpy()
        traj.append(state.sim.q[0].cpu().numpy())
    traj = np.stack(traj)
    T = data["qdd"].shape[0]
    g = dict(qdd0=float(np.abs(qdd0 - data["qdd"][0]).max()),
             half=float(np.abs(traj[:T // 2] - data["q"][:T // 2]).max()),
             all=float(np.abs(traj - data["q"]).max()))
    log(f"golden on the GPU: first q̈ {g['qdd0']:.3e} (< 2e-3), first half "
        f"{g['half']:.3e} (< 5e-3), all {g['all']:.3e} (< 2e-2)")
    check(g["qdd0"] < 2e-3 and g["half"] < 5e-3 and g["all"] < 2e-2,
          "golden trajectory on the GPU")
    return dict(parity_max_abs_q=err, wide=wide, golden=g)


def phase_hull_parity() -> dict:
    """Hull tier, GPU (K4) against CPU (plain versions): 128 envs take the
    broad phase and the warm carry, 8 envs every pair cold."""
    out = {}
    for B in (128, 8):
        err = float((parity_q("cuda", 0.1, 0.05, geometry="hull", B=B)
                     - parity_q("cpu", 0.1, 0.05, geometry="hull",
                                B=B)).abs().max())
        log(f"hull parity: {B} envs x 5 ticks from q ± 0.1, q̇ ± 0.05, "
            f"max|q_gpu - q_cpu| {err:.3e} (atol {PARITY_ATOL})")
        check(err <= PARITY_ATOL, f"hull GPU/CPU parity at B={B}")
        out[f"B{B}"] = err
    return out


def phase_scene05_parity() -> float:
    err = float((parity_q("cuda", 0.1, 0.05, scene=SCENE05)
                 - parity_q("cpu", 0.1, 0.05, scene=SCENE05)).abs().max())
    log(f"scene 05 parity: 128 envs x 5 ticks from q ± 0.1, q̇ ± 0.05, "
        f"max|q_gpu - q_cpu| {err:.3e} (atol {PARITY_ATOL})")
    check(err <= PARITY_ATOL, "scene 05 GPU/CPU parity")
    return err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    check(torch.cuda.device_count() == 1,
          f"needs one card, sees {torch.cuda.device_count()}")
    device = torch.device("cuda")
    cards = card_lines()
    card = cards[0]
    log(f"card: {'; '.join(cards)}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib = _build.build()
    build_s = time.perf_counter() - t0
    log(f"build: {lib} in {build_s:.1f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"  {line.strip()}")

    env = envs.make(SCENE)
    k1 = phase_k1(env, device)
    k2a, k2b = phase_k2(device)
    k3 = phase_k3(device)
    k4 = phase_k4(env, device)
    launches, main_path = phase_main_path(card, "capsule")
    hull_launches, hull_path = phase_main_path(card, "hull")
    parity = phase_parity()
    hull_parity = phase_hull_parity()
    t0 = time.perf_counter()
    k5 = phase_k5(device)
    scene05_parity = phase_scene05_parity()
    k5_s = time.perf_counter() - t0
    log(f"phase 11 and scene 05 parity: {k5_s:.1f} s")

    kernels = [k1, k2a, k2b, k3, k4, k5]
    for rec in kernels:
        # each kernel's count from the path that runs it (K2a/K2b, K5: none)
        rec["launches"] = max(launches[rec["name"]],
                              hull_launches[rec["name"]])
        rec["launches_capsule_path"] = launches[rec["name"]]
        rec["launches_hull_path"] = hull_launches[rec["name"]]
    record = dict(card=card, torch=torch.__version__, build_s=build_s,
                  kernels=kernels, main_path=main_path, hull_path=hull_path,
                  parity=parity, hull_parity=hull_parity,
                  scene05_parity=scene05_parity, phase11_s=k5_s)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
