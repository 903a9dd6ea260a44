"""Smoke run of the PyTorch/CUDA port (rmp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases N,N,...]

Phases, in order; any failure raises and the run exits non-zero without
printing the result line. Each logs `phase N: x s` with the seconds of its
instrumented parts (SPENT) and how many torch.profiler attempts its traces
needed. `--phases` (development) runs the card, the build and the named
phases with those whose records they read, and prints no result line.
After the build, CPU_WORKERS worker processes make the CPU side of the
GPU/CPU parities (cpu_reference_calls) while the card runs; each phase
takes its results where it needs them (cpu_run). Rollout traces record the
CUDA activity alone over PROFILE_TICKS ticks, and the timed rollouts of
the scenes other than the flagship that carry no statistical check run
PATH_TICKS ticks (both cut for time in the eighteenth slice: 10 and 150
ticks before).
  1. card: name and power limit (nvidia-smi), torch version; needs CUDA.
  2. build: every kernel of the main path, built by nvcc from
     rmp_tpu_torch/csrc/ (seconds printed).
  3. K1 (pullback + pivoted-LU resolve): the build's registers, shared
     memory and spills; kernel against its plain PyTorch version at the
     flagship layout, at B = 4096 and at the ragged B = 1, 7, 4093, on
     seeded contiguous random blocks and on the strided blocks of a real
     tick; a rank-1 Gram case must stay finite. The wrapper on the real
     blocks must launch one device kernel (torch.profiler). Timed with CUDA
     events beside its bound and an einsum + torch.linalg.solve yardstick:
     the wrapper call from an idle stream (`ms`, host time to the launch
     included) and with the stream kept busy ahead (`device_ms`).
  4. K2a (pullback_resolve, pullback_resolve_t; ridge 1e-6) and K2b
     (pullback_resolve_blocks; ridge 0), the dense-block entry points on
     K1's kernel (K2a's batch-minor views and K2b's row slices read
     through their strides), against their plain versions at R = 30,
     n = 9, B = 4096, 1, 7 and 4093, timed at B = 4096 beside an einsum +
     torch.linalg.solve yardstick.
  5. K3 (FK derivatives): the build's counts; kernel against its plain
     version at B = 4096, 1, 7 and 4093; one device kernel per call; timed
     as K1.
  6. K4 (GJK, link hulls vs obstacles): the build's counts; kernel
     against its plain version at the flagship shapes (10 links x top-3
     slots x 4096 envs, 96-vertex hulls), from reset states moved by
     q ± 0.3: a cold 10-iteration query and a warm 4-iteration one seeded
     from it. Tolerance (quantile-based, as in tests/test_torch_gjk.py):
     |Δdist| p99 < 1e-4 and median < 1e-6; where distances agree to 1e-5,
     witnesses p99 < 1e-4 and max < 5e-2; every output finite. Then
     against a float64 run of the plain version at 128 iterations and each
     pair's lower bound of its true distance (k4_evidence): witnesses
     consistent with distances, no distance below what the supports can
     reach, Minkowski points inside their balls, at most 0.1% of pairs
     parting by more than 1e-3, and the kernel (and the float32 plain
     version) at 128 iterations within 1e-4 of the float64 distances on all
     but 0.1% of the pairs. The cold query at B = 1, 7 and 4093 (the first
     envs of the same operands) against the plain version, and bit for bit
     equal to the 4096-env call's first envs. Then the hull main path's own
     warm operands (the phase-8 env 20 ticks in, its gjk_warm carry,
     k4_main_path_operands): kernel against plain; the same operands with
     the first half of the envs started at each pair's converged Minkowski
     point (whole warps freeze at iteration 1 and leave the loop early)
     against plain, 10 iterations; one device kernel per
     call, the share of pairs still changing after iterations 1-4 (plain
     runs at i and i + 1 iterations), and the kernel timed beside the bound
     of what those pairs need (k4_bound_needed; the old every-iteration
     count printed beside it).
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
     and 05 at B = 4096: the build's counts and dynamic shared memory;
     kernel against plain version near the ready pose (every env, and at
     B = 1, 7 and 4093) and from the wide states of tests/test_pallas_tick.py
     (envs that are finite, stable under a one-ulp move of q and q̇, and
     within 1e-5 of a float64 plain run), limit 2e-4 x max(1, |q̈|); kernel
     against the standard q̈ (evaluate_policies, 'cholesky') on the
     first-capsule model, and its gap to the full 25-capsule model printed
     as a number; one device kernel per call. Timed: K5 (idle stream and
     stream kept busy), its plain version and the standard q̈ evaluation it
     stands in for (FK bundle + context + blocks + K1). K5 runs on no main
     path: phases 7-8 hold its count at 0. Then scene 05 GPU/CPU parity,
     128 envs x 5 ticks from q ± 0.1, q̇ ± 0.05.
 12. the sixth slice: K1 at n = 6 (the UR5's two layouts) and n = 2 (two
     two-joint layouts) against its plain version on random contiguous
     blocks and on a real tick's strided blocks at B = 4096, 1, 7 and 4093,
     one device kernel per call, timed beside its bound; K3 on the
     two-joint robot (F = 3, n = 2) and the UR5 (F = 7, n = 6) likewise;
     ur5/01 and ur5/02 at 4096 envs x 150 ticks, K1 and K3 once per tick,
     each with its 10-tick trace; GPU/CPU parity (128 envs x 5 ticks) of
     the nine new scenes and of franka/01 in torque mode, on the envs whose
     CPU run lies within 1e-5 of a float64 run (witness_q); the goldens
     franka01, two_joint01 and franka01_torque reproduced through
     RmpCore on the GPU.
 13. the seventh slice: K1 on moving_goal's real-tick layout (a dense
     3-row attractor and three identity leaves) against its plain version
     at B = 4096, 1, 7 and 4093, one device kernel per call, timed beside
     its bound; K4 on franka/moving_obstacles' own warm operands (hull
     tier, 4096 envs 20 ticks in, the carry of the obstacles' previous
     positions, the scene's 4 iterations) against its plain version with
     phase 6's limits and float64 evidence, timed beside its bound;
     4096-env rollouts of franka/moving_goal and
     franka/moving_obstacles ('solve', 150 ticks; moving_obstacles also in
     the hull tier, its warm carry following the moving cylinders) and of
     franka/03_self_avoidance, franka/04_nullspace_control and
     franka/pose_target ('pinv', PINV_TICKS ticks), K1 (where 'solve'),
     K3 and K4 (hull) once per tick, each with its 10-tick trace; the
     'pinv' resolve of a real tick timed alone (torch.linalg.pinv's batched
     SVD), and its ticks one by one; GPU/CPU parity of the five scenes
     (witness_q's screens); moving_obstacles in the hull tier at 128 envs
     and the scene's 4 and 16 warm GJK iterations (moving_hull_parity):
     every K4 call of the card's run against its plain version on the same
     operands with phase 6's limits, and q within 1e-3 of the CPU and of
     float64 on the envs that a one-ulp move, float64 and the card's run
     with the plain version in K4's place each leave within 1e-5 of the
     CPU; franka/04's IK start on the card against the CPU; the
     Simulation wrapper's reference loop on the card (the EE ends nearer
     its goal, q within 2e-3 of the CPU's).
 14. the eighth slice, franka/randomized_cluttered: K1 on its real tick 60
     ticks into a rollout (dense 3 + three identities + scalar 80, per-env
     gains) against its plain version at B = 4096, 1, 7 and 4093, one
     device kernel per call, timed beside its bound; K4 on its own warm
     operands (hull tier, 4096 envs 20 ticks in, per-env random cylinders
     and 50 m pad slots, 8 iterations) with phase 6's limits and float64
     evidence, timed beside its bound; 4096 envs x 300 ticks from the
     reset of seed 0 in the capsule and the hull tier: one tick first with
     the sync debug mode on (no synchronizing call), then the rollout
     timed, K1 once per tick, K3 1 + 8 times per tick (the detour IK's 8
     DLS steps, the first sharing the EE's launch), K4 once per hull tick;
     the task statistics held against reports/eval_randomized.json and
     reports/eval_randomized_hull.json within 3 sigma of the difference of
     two 4096-env samples, nan_rate 0; each with its 10-tick trace; GPU/CPU
     parity, 128 envs of one CPU reset moved to the card, PARITY_TICKS
     ticks, per (env, tick) before the env's first detour or resample and while the
     one-ulp, float64 (and in the hull tier card-without-K4) screens hold
     (randomized_parity), every K4 call of the hull run against its plain
     version.
 15. the ninth slice, the dual-arm Panda (26 frames, 18 motors): K1 at
     n = 18 (its own warp-per-env kernel; the build's registers, shared
     memory and spills) on both dual layouts against its plain version,
     random contiguous blocks and each scene's real tick 60 ticks into a
     rollout, at B = 4096, 1, 7 and 4093 (envs with a non-finite plain q̈
     left out and counted), one device kernel per call, timed beside its
     bound; K3 on the dual model likewise, then the Panda's K3 timed again;
     the dual handover golden on the card (q within 1e-4, solved_count
     exact); K4 on the randomized dual scene's cold operands (20 links x 8
     slots x 4096 envs, 10 iterations) with phase 6's distance limits and
     k4_evidence's cap_fault form on every pair; dual_panda/
     randomized_clutter at 4096 envs x 300 ticks in both tiers (a tick
     under the sync debug mode first; K1 and K3 once per tick, K4 once per
     hull tick; the statistics against reports/eval_dual_randomized*.json
     within 3 sigma, nan_rate 0; 10-tick traces); dual_panda/handover at
     4096 x 150 with its trace; GPU/CPU parity of the randomized scene in
     both tiers and of the handover in the hull tier per (env, tick)
     behind the one-ulp, float64 and card-with-plain-kernels screens
     (randomized_parity, cut to DUAL_PARITY and HANDOVER_HULL_PARITY), of
     the handover and of franka/03 in the hull tier behind witness_q.
 16. the tenth slice (contact, the two-joint and UR5 hull tiers, the
     learned scenes): K4 on the two-joint robot's (3 links, 48 rows) and
     the UR5's (6, 130) main-path warm operands (4 iterations) with phase
     6's limits and k4_evidence's cap_fault form, one device kernel per
     call, timed beside k4_bound_needed, with the share of pairs whose
     support ties; K1 on ur5/02's hull tick (n = 6) and on
     franka/neural_clutter's tick (the learned leaf's 80 scalar rows) at
     B = 4096, 1, 7 and 4093; franka/02_provoke_collision at 4096
     identical envs x 120 ticks with contact and as the contact-free
     ghost (K3 11 and 1 times per tick, no other kernel), tests/
     test_contact.py's criterion on every env, the synchronizing calls of
     a contact tick (the 'pinv' resolve's SVD only), its tick time and
     trace, K3 against plain on its final state; the impulse model on the
     card (the collapsing arm at 128 envs against the CPU, the KKT check
     of 12 random scenes at 1500 sweeps); two_joint/05, its variant and
     ur5/02 in the hull tier at 4096 x 150 (K4 once per tick); the two
     reach scenes at 4096 x 150 and tests/test_neural.py's criteria on
     4096 envs; franka/neural_clutter at 4096 x 300 from seed 0 against
     reports/eval_neural_clutter.json within 3 sigma, nan_rate 0;
     GPU/CPU parity (randomized_parity's screens) of franka/02 from
     piercing states, of the three hull tiers and of the three learned
     scenes.
 17. the eleventh slice, gradients and training: the backward of K1
     (scene 06's real-tick blocks), K3 (the Panda and the dual Panda) and
     K4 (the hull main path's warm operands) at B = 4096 with random
     cotangents: each wrapper's autograd Function against autograd through
     its plain version (K4: against its envelope rule fed the plain
     forward's outputs, at quantiles), each behind a float64 plain run,
     the Function's outputs carrying its grad_fn, forward and backward
     timed beside the backward's bound; K2a and K2b under grad (grad_fn,
     one launch each) and K5 raising; K1's transposed solve against its
     plain version, timed beside torch.linalg.solve on Aᵀ; tune_gains'
     loss and gradient through franka/06's batched 'solve' rollout in both
     tiers, franka/01 ('cholesky') and two_joint/05's hull tier per env
     (128 envs x 10 ticks), on the card with the kernels (every counter
     zeroed before, read after: K1, its transposed solve, K3 and K4 once
     per tick where the path runs them), on the card with plain_kernels()
     and on the CPU, within 1e-3 of the CPU's norm or 3 x the CPU's
     distance to a float64 run (the hull tiers also by cosine > 0.999 and
     a norm ratio in (0.98, 1.02)); remat on the card (the same loss,
     gradients within 1e-4, and with a resample in a recomputed tick the
     generator where the run without remat leaves it); train_neural_rmp's
     entry point at its defaults for 2 steps, an optimizer step timed
     (launches, peak memory, its trace), tests/test_neural.py's descent
     criterion from its own net and episodes
     (rmp_tpu_torch/experiments/reach_descent_case.npz);
     train_neural_clutter's entry point at its defaults (1024 envs x 100
     ticks, remat) for one step, timed from the inside (time, launches,
     envs dropped, peak memory), and one step without remat over 10
     ticks;
     tune_gains --geometry hull on franka/06 for 3 steps of 20 ticks.
 18. the twelfth slice, K1 and K5 at every n, K1's bf16 loads, the N-link
     arm (M18): K1 against its plain version at every n from 1 to 32 (the
     lane kernel to 9, the warp kernel above) on float32 and on bfloat16
     blocks at B = 4096 (the warp kernel also at 1, 7 and 4093; random
     layouts drawn on the card), a 20-block
     layout, n = 33 and 33 blocks raising before a launch, the flagship's
     real tick in bfloat16 (kernel on the cast blocks, block_dtype the
     same call), timed at n = 5, 12, 18, 32 and on the flagship in bf16
     and float32 beside their bounds (bfloat16 counted at 2 bytes) and
     einsum + torch.linalg.solve; K2a and K2b fed by core.policy_rows and
     core.policy_row_blocks on the five-link arm at 4096 envs against
     their plain versions and K1's q̈; K5 at n = 5 and 12 on the planar
     arms' inputs against its plain version and the env's own batched
     step's q̈ (2e-4), one launch per call, timed beside its bound; the
     planar arms (envs/planar.py) at 4096 x 150 ticks ('solve', K1 and
     K3 once per tick, no synchronizing call, every q finite, the median
     EE-goal distance before and after, a 10-tick trace) with GPU/CPU
     parity (128 x 5); the flagship at 4096 x 150 in float32 and with
     fused_blocks_dtype 'bf16', side by side, and JAX's bf16 contract on
     the card (128 reset envs x 2 ticks, within 1e-2, not identical); the
     flagship with RMP_PANDA_CAPS=fine (47 capsules) at 4096 x 30 with
     GPU/CPU parity.
 19. the thirteenth slice, K3 past 18 motors, M16 and M17's entry points:
     K3's two kernels' build lines (the narrow one: 32 frames, 18 motors,
     8 envs a CTA; the wide one of fk_derivatives_wide.cuh: 40, 32, 4);
     the kernel against its plain version on the 24- and 32-link arms,
     two odd n (19, 31), 40 frames with 32 motors and a branched tree at
     B = 4096, 1, 7 and 4093 (2e-4 x max(1, max |plain|) per output, each
     beside its and the plain version's gap to float64), 41 frames and 33
     motors raising before a launch, the two arms timed beside their
     bounds with the wide kernel's shared bytes a CTA and envs an SM, and
     the Panda and dual Panda re-timed beside their earlier 0.0268 /
     0.0824 ms; K1's warp kernel at n = 24 and 32 on the arms'
     real ticks (strided blocks) at B = 4096, 1, 7 and 4093, kernel and
     plain version each against a float64 plain run (float32 q̈ there
     parts from it by ~4e-4 of |q̈|: the kernel's backward error within
     1e-5, its forward error within max(2e-4, twice the plain version's),
     k1_compare_conditioned), timed beside its bound and einsum +
     torch.linalg.solve; the 24- and 32-link arms (envs/planar.py) at
     4096 x 150 like phase 18's (the envs that start piercing the cylinder
     counted) with GPU/CPU parity (128 x 5, witness_q's screen); M16 at
     world size 1 on NCCL over the loopback address: make_sharded_rollout
     of the flagship (4096 x 20 from perturbed resets) equal to
     make_rollout bit for bit with the same launches, its collectives 5
     scalar all-reduces (record_collectives / audit_collectives), the
     sharded checkpoint restored bit for bit, the group destroyed; M17:
     `python -m rmp_tpu_torch.experiments.evaluate` on
     franka/randomized_cluttered at 4096 x 300 against
     reports/eval_randomized.json (3 sigma, nan_rate 0), latency.measure on
     the flagship at batches 1, 64, 4096 (25 ticks), the soak at 4096 x
     250 in chunks of 125 (finite, in limits); then, once that timed work
     is done, the processes that nothing times, started together
     (run_together): `run franka/01 --ticks 40`, phase 20's `run --gif`
     and phase 21's asset tools, which those phases read (ran).
 20. the fourteenth slice, K5 past 16 motors, row-keyed resampling
     streams, M17's second half: the wide K5's two instantiations' build
     lines (N = 24, 32); the kernel on every layout of k5_wide_layouts (the
     17-, 24- and 32-link arms, also at B = 1, 7 and 4093; n = 19 and 31;
     the 40-frame tail; a branched tree; four cylinders an env) at B =
     4096 against its plain version on the envs that the card's and the
     CPU's float32 plain runs both keep within 1e-5 of float64, and on the
     rest against the float64 system beside the plain version (backward
     and forward error at the 99th percentile within twice the plain
     version's; the largest printed), each timed beside its shared bytes a
     CTA and envs an SM; one device kernel a call; timed at 24 and 32 links
     beside its bound; 33 motors and grad raising before a launch; the
     16-lane K5 re-timed on scene 06 against 0.0375 ms (5%); the
     randomized Panda sharded at world size 1 on NCCL (1024 x 30, goals
     resampled) equal to make_rollout bit for bit; sweep_randomized (G = 2,
     256 x 100) and the dual scene's sweep_escape (256 x 15); trace_report
     on the flagship (its K1 and K3 us per tick within 10% of phase 7's
     trace, and by source); profile_tick at 4096; gjk_warm_accuracy
     (1024 x 20, K4); make_gifs, Simulation's capture and `run --gif`
     through the native renderer into chiprun_out/gifs/; the viewer's
     HTTP round trip on the loopback address.
 21. the fifteenth slice, the exported serving step, K1/K3/K4 as
     torch.library ops, the compile probe and the asset tools:
     experiments/compile_probe (the cold nvcc build of every source,
     per source: phase 2's where this process built the kernels, the
     probe's own into a temporary directory where it found them built;
     the cached load; the flagship's first and steady tick at 4096; its
     export at 4096 envs, one tick a call: trace, torch.export, save,
     load, first and steady call); that capsule artifact's graph holds
     K1's and K3's ops, and the hull tier's, exported the same way, K4's
     too; a fresh process that imports torch and the ops module alone
     (ARTIFACT_CHILD) loads them and runs 150 closed-loop calls of the
     capsule artifact and 30 of the hull one (steps/s, the wrappers'
     launches, device kernels a call by torch.profiler, beside phase 7's
     eager trace of the same tier), each equal bit for bit to the eager
     rollout on the same 0-d tensor gains, and the capsule artifact within
     PARITY_ATOL of the eager rollout on Python-number gains, the users'
     path, on every env (CUDA divides by a host scalar as a reciprocal
     multiply, so the two part by rounding);
     a CPU-traced artifact (`--platforms cpu,cuda`, 128 envs) moved to the
     card in that process launches K1 and K3 and stays within the GPU/CPU
     parity limit of the eager card run; fit_hulls (96 vertices, every
     link), fit_capsules (two links, 600 steps, on the card) and
     collision_mesh_error (4096 configurations) on OBJs written from
     assets/panda_visual.npz into a temporary directory, outputs and times
     into chiprun_out/assets15/, assets/ and reports/ untouched.
 22. the eighteenth slice, K1's warp kernel (n = 10..32,
     csrc/pullback_resolve_wide.cuh) redesigned: its ptxas lines at every n
     (no spills); the pivot cases of rmp_tpu_torch/ops/resolve_cases.py
     (exact ties in a singular integer system, negative pivots, tiny
     pivots clamped with their sign, NaN) at n = 10, 18 and 32 in float32
     and bfloat16 at B = 4096, 1, 7 and 4093 against the plain version
     (envs with a NaN q̈ the same on both sides); the planar twelve-link
     arm's real tick at those batches; K1's backward solve (A through
     transposed strides) at n = 18 and 32; the target layouts' device
     times (phases 15, 18, 19) beside their bounds and half the bound.
Then one JSON line of per-kernel numbers ({"kernels": [...]}) and, last,
{"ok": true, "device": {...}}. The full record also goes to
chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import inspect
import json
import multiprocessing
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from rmp_tpu_torch import _build, convert, core, envs
from rmp_tpu_torch import taskmaps as tm
from rmp_tpu_torch.core import policy_row_blocks_structured
from rmp_tpu_torch.envs import franka
from rmp_tpu_torch.envs import neural_clutter as clutter_env
from rmp_tpu_torch.envs import neural_reach as reach_env
from rmp_tpu_torch.envs import planar
from rmp_tpu_torch.envs.base import (_policy_inputs, _seed_gjk_warm,
                                     _wants_gjk_warm,
                                     make_batched_control_step)
from rmp_tpu_torch.evaluate import min_clearance, task_statistics
from rmp_tpu_torch.experiments import common as exp_common
from rmp_tpu_torch.experiments import (latency, soak, train_neural_clutter,
                                       train_neural_rmp, tune_gains)
from rmp_tpu_torch.models import kinematics, robots, specs, urdf
from rmp_tpu_torch.models.fk_derivatives import fk_derivatives
from rmp_tpu_torch.models.urdf import FIXED
from rmp_tpu_torch.ops import (cuda_fk, cuda_gjk, cuda_resolve, cuda_tick,
                               tick_ops)
from rmp_tpu_torch.ops.resolve_cases import (PIVOT_CASES, SINGULAR,
                                             pivot_case)
from rmp_tpu_torch.parallel import (audit_collectives, distributed,
                                    make_sharded_rollout, record_collectives,
                                    shard_env_batch)
from rmp_tpu_torch.policies import neural, v1
from rmp_tpu_torch.sim import (FrankaPanda, Goal, Simulation, collision,
                               contact, data, dynamics)
from rmp_tpu_torch.sim.world import SimState, physics_step
from rmp_tpu_torch.utils.checkpoint import (_leaves as ckpt_leaves,
                                            restore_checkpoint_sharded,
                                            save_checkpoint_sharded)

ROOT = os.path.dirname(os.path.abspath(__file__))
SCENE = "franka/06_cluttered_environment"
SCENE05 = "franka/05_obstacle_avoidance"
BATCH = 4096
TICKS = 150
# the timed rollouts of the other scenes, which carry no statistical check
# (150 before the eighteenth slice)
PATH_TICKS = 50
WARMUP_TICKS = 2
REPS = 30
RAGGED = (1, 7, 4093)  # batches that fill no tile evenly
# GPU spin ahead of a timed call (~1.1 ms at the H100's boost clock), so the
# host's time to enqueue the call hides behind it
LEAD_CYCLES = 2_000_000
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
K4_CAP_COS = 0.99          # |cos(x*, cylinder axis)| of an end-cap contact
PARITY_ATOL = 1e-3     # GPU vs CPU q after 5 ticks
STABLE = 1e-5          # a one-ulp move of the start moves the CPU run less
PROFILE_TICKS = 3      # 10 before the eighteenth slice
TRACE_PAD_S = 0.02     # host wait on each side of a traced span
# traces of a span before its device records count; why torch.profiler
# sometimes keeps none of a span's device records is not known (PERF.md
# section 7)
TRACE_ATTEMPTS = 8


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


# seconds spent in the instrumented functions below (keys: the function's
# name, with its device where `by` names the argument that holds it); a
# call nested in another counts in both
SPENT: dict[str, float] = {}
# (what, attempts) of every span traced with retries (device_launches,
# profile_ticks): how many `traced` attempts each needed
TRACE_TRIES: list = []


def spent(by: str | None = None):
    """Decorator: add the wrapped function's wall seconds to SPENT."""
    def wrap(fn):
        sig = inspect.signature(fn) if by else None

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            key = fn.__name__
            if by:
                dev = sig.bind(*args, **kwargs).arguments.get(by)
                key += f" {getattr(dev, 'type', dev)}"
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                SPENT[key] = SPENT.get(key, 0.0) + time.perf_counter() - t0
        return inner
    return wrap


@contextlib.contextmanager
def part(name: str):
    """Add the wall seconds of the block to SPENT[name]."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        SPENT[name] = SPENT.get(name, 0.0) + time.perf_counter() - t0


PHASE_S: dict[int, float] = {}    # seconds of each phase run


def run_phase(number: int, start: float, fn, *args, **kwargs):
    """fn(*args, **kwargs) as phase `number`: logs `phase N: x s`, with the
    seconds of the instrumented functions it ran (SPENT) and the attempts
    its traces needed (TRACE_TRIES); keeps the seconds in PHASE_S."""
    t0 = time.perf_counter()
    before, tries = dict(SPENT), len(TRACE_TRIES)
    out = fn(*args, **kwargs)
    seconds = time.perf_counter() - t0
    PHASE_S[number] = seconds
    parts = {k: round(v - before.get(k, 0.0), 1) for k, v in SPENT.items()
             if v - before.get(k, 0.0) >= 0.05}
    attempts: dict[int, int] = {}
    for _, n in TRACE_TRIES[tries:]:
        attempts[n] = attempts.get(n, 0) + 1
    log(f"phase {number}: {seconds:.1f} s (ends at "
        f"{time.perf_counter() - start:.1f} s); parts {json.dumps(parts)}; "
        f"traced spans by attempts needed {json.dumps(attempts)}")
    return out


# The CPU side of a GPU/CPU parity (the port on the CPU, its one-ulp and
# float64 screens) depends only on start states fixed before the card's run,
# so CPU_WORKERS worker processes (one thread each) make it while the card
# runs the phases before: start_cpu_runs begins them after the build,
# cpu_run takes each result where its phase needs it.
CPU_WORKERS = 5
_cpu: dict = {}      # "pool": the workers; a call's key: its AsyncResult


def _cpu_key(fn, args, kwargs) -> str:
    return repr((fn.__name__, args, sorted(kwargs.items())))


def _cpu_worker() -> None:
    torch.set_num_threads(1)


def _cpu_task(name: str, args, kwargs):
    return globals()[name](*args, **kwargs)


def start_cpu_runs(calls) -> None:
    """Begin each (fn, args, kwargs) of `calls`, a run on the CPU alone, in
    the worker processes, in order."""
    pool = _cpu["pool"] = multiprocessing.get_context("spawn").Pool(
        CPU_WORKERS, initializer=_cpu_worker)
    for fn, args, kwargs in calls:
        _cpu[_cpu_key(fn, args, kwargs)] = pool.apply_async(
            _cpu_task, (fn.__name__, args, kwargs))


def cpu_run(fn, *args, **kwargs):
    """fn(*args, **kwargs), a run on the CPU alone: the workers' result
    where start_cpu_runs began it (the worker's exception, if it raised, is
    raised here), else made here. The seconds spent waiting go to SPENT."""
    pending = _cpu.pop(_cpu_key(fn, args, kwargs), None)
    if pending is None:
        return fn(*args, **kwargs)
    t0 = time.perf_counter()
    out = pending.get()
    SPENT["cpu_run wait"] = (SPENT.get("cpu_run wait", 0.0)
                             + time.perf_counter() - t0)
    return out


def stop_cpu_runs() -> None:
    """End the worker processes, whatever they still run."""
    pool = _cpu.pop("pool", None)
    _cpu.clear()
    if pool is not None:
        pool.terminate()
        pool.join()


# The entry points that nothing times run together in phase 19, once its
# timed work is done: `run`, `run --gif` (phase 20's check) and the asset
# tools (phase 21's). Phases 20 and 21 read theirs here (`ran`): key ->
# (stdout, seconds from the start to its end, taken beside the others').
_RAN: dict = {}
RUN = [sys.executable, "-m", "rmp_tpu_torch.experiments.run"]
GIF_RUN = os.path.join(ROOT, "chiprun_out", "gifs", "run_franka01.gif")
GIF_RUN_CMD = RUN + ["franka/01_target_rmp_only", "--ticks", "10", "--gif",
                     GIF_RUN]
# phase 21's asset tools in a process of their own: argv the function's
# name and the card's line; the record on the last line
ASSET_CHILD = r"""
import json, sys
import torch
import chip_smoke as cs
print(json.dumps(getattr(cs, sys.argv[1])(sys.argv[2],
                                          torch.device("cuda"))))
"""
TOGETHER_S = 900                   # the most run_together waits


def asset_tools_cmd(card: str) -> list:
    """The command of phase 21's asset tools (phase_asset_tools) in a
    process of their own."""
    return [sys.executable, "-c", ASSET_CHILD, phase_asset_tools.__name__,
            card]


@spent()
def run_together(cmds: dict) -> dict:
    """{key: (stdout, seconds from the start to its end)} of each command
    of `cmds` (key -> argv), all started at once, each a process of its own
    (the card its default device). A failure, or a process still running
    after TOGETHER_S, raises; every process has ended when this returns."""
    t0 = time.perf_counter()
    logs = tempfile.mkdtemp(prefix="chip_smoke_together_")
    procs, ended = {}, {}
    try:
        for i, (key, cmd) in enumerate(cmds.items()):
            # files, not pipes: a full pipe would stop a process unread
            out = open(os.path.join(logs, f"{i}.out"), "w+")
            err = open(os.path.join(logs, f"{i}.err"), "w+")
            procs[key] = (subprocess.Popen(
                cmd, cwd=ROOT, stdout=out, stderr=err, text=True,
                env={**os.environ, "PYTHONPATH": ROOT}), out, err)
        while len(ended) < len(procs):
            check(time.perf_counter() - t0 < TOGETHER_S,
                  f"{sorted(set(procs) - set(ended))} still running after "
                  f"{TOGETHER_S} s")
            for key, (proc, _, _) in procs.items():
                if key not in ended and proc.poll() is not None:
                    ended[key] = time.perf_counter() - t0
            time.sleep(0.1)
        result = {}
        for key, (proc, out, err) in procs.items():
            out.seek(0)
            err.seek(0)
            check(proc.returncode == 0, f"{key} failed: {err.read()[-2000:]}")
            result[key] = (out.read(), ended[key])
        return result
    finally:
        for proc, out, err in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
            err.close()
        shutil.rmtree(logs, ignore_errors=True)


def ran(key: str, cmd: list) -> tuple[str, float]:
    """(stdout, seconds) of `cmd` as phase 19 ran it under `key`, read once;
    run now, alone, where phase 19 did not run it."""
    if key in _RAN:
        return _RAN.pop(key)
    return run_together({key: cmd})[key]


def card_lines() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


@spent()
def time_ms(fn, reps: int = REPS, lead: bool = False) -> float:
    """Median device time of fn() over `reps` calls, by CUDA events. The
    stream is idle at each start, so a call's host time up to its last
    launch counts; with `lead` a spin kernel keeps the stream busy ahead of
    the start event, so the events time the call's device work alone."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if lead:
            torch.cuda._sleep(LEAD_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


@spent()
def traced(fn, warm=None, host_ops: bool = True):
    """Events of one torch.profiler trace of fn(). The profiler switches the
    device activities on one step ahead, in a warm-up step that runs `warm`
    (default fn) and is not kept, and the kept step waits TRACE_PAD_S on
    each side of fn. A trace started and stopped around a short span alone
    lost some and once all of its device records on the H100 (K5: 8, 9 and
    0 of 10 kernels recorded, while the host saw 10 launch calls). Without
    host_ops the profiler records the CUDA activity only (kernels and the
    runtime's calls, no PyTorch operators), which the device's own numbers
    need: the operators' events are most of a trace and of the seconds
    prof.events() takes to read it."""
    activities = ([ProfilerActivity.CPU] if host_ops else []) + [
        ProfilerActivity.CUDA]
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        (warm or fn)()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(TRACE_PAD_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
    return prof.events()


def device_records(events) -> list:
    """The device records of a trace, less the profiler's own step spans."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("ProfilerStep")]


def device_kernels(events) -> list:
    """device_records of a trace less those of work that ran before it: a
    record that starts more than TRACE_PAD_S / 2 before the trace's first
    host event (other than a profiler step span). CUPTI may hand a record on
    late, into a later trace (on the H100 a trace of 10 K1 calls held 12
    kernels for its 10 launch calls); traced's kept span begins TRACE_PAD_S
    after the last work before it, so no record of that span is dropped.
    A trace with no host event keeps every record."""
    records = device_records(events)
    host = [e.time_range.start for e in events
            if e.device_type == torch.autograd.DeviceType.CPU
            and not e.name.startswith("ProfilerStep")]
    if not host:
        return records
    first = min(host) - TRACE_PAD_S * 1e6 / 2    # time_range is in us
    return [e for e in records if e.time_range.start >= first]


@spent()
def device_launches(fn, kernel: str, what: str, calls: int = 10) -> float:
    """Kernel launches per call of fn, from a torch.profiler trace of
    `calls` calls: the runtime's launch calls (cudaLaunchKernel*) on the
    host side, and every device kernel the trace recorded must be `kernel`
    (a substring of its name). A trace that records fewer device kernels
    than launch calls is taken again, up to TRACE_ATTEMPTS traces; the one
    that recorded most is checked, and its device records must not exceed
    the launch calls."""
    fn()
    torch.cuda.synchronize()

    def calls_of_fn():
        for _ in range(calls):
            fn()

    best = None
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        events = traced(calls_of_fn)
        names = [e.name for e in device_kernels(events)]
        late = len(device_records(events)) - len(names)
        runtime = sum(1 for e in events
                      if e.device_type == torch.autograd.DeviceType.CPU
                      and e.name.startswith(("cudaLaunchKernel",
                                             "cuLaunchKernel")))
        log(f"{what} trace {attempt} of {calls} calls: {runtime} launch "
            f"calls, {len(names)} device kernels recorded"
            + (f" ({late} records of earlier work dropped)" if late else ""))
        if best is None or len(names) > len(best[0]):
            best = names, runtime
        if len(names) == runtime:
            break
    TRACE_TRIES.append((what, attempt))
    names, runtime = best
    other = sorted({n[:80] for n in names if kernel not in n})
    check(not other, f"{what}: the wrapper launches {other}")
    check(0 < len(names) <= runtime, f"{what}: {len(names)} device kernels "
          f"for {runtime} launch calls")
    return runtime / calls


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


@spent()
def k1_bound(tags, blocks):
    """Bound of the wrapper call: it reads each identity block (n² + n),
    the dense rows (2n + 1 each) and the scalar rows (n + 2 each) once, in
    each block's element type (4 bytes, 2 for bfloat16), and writes q̈ (n
    floats), per env; flops of the seed's sums, the accumulation and the
    LU."""
    B, n, Rd, Rs = k1_layout(tags, blocks)
    n_id = tags.count("identity")
    n_bytes = B * (4 * n + sum(x[0].numel() * x.element_size()
                               for blk in blocks for x in blk))
    flops = (n_id * (n * n + n)                          # seed, seed + rows
             + Rd * (2 * n + 2 * n * n)                  # J^T W, J^T v
             + Rs * (3 * n + n * (n + 1))                # m J, upper J^T m J
             + sum((n - k - 1) * (2 * (n - k) + 3) for k in range(n))  # LU
             + n * n + n)                                # back substitution
    return bound_ms(float(n_bytes), float(flops) * B)


@spent()
def k1_library(tags, blocks):
    """Yardstick: einsum accumulation + torch.linalg.solve."""
    A, f = cuda_resolve.assemble_structured(tags, blocks)
    return torch.linalg.solve(A, f)


# K1's kernels: n <= K1_LANE_N on 8 lanes an env, above on a warp an env
K1_LANE_N = 9
K1_WIDE_SOURCE = "pullback_resolve_wide.cuh"   # instantiated in three .cu


# the flagship's block layout: (tag, rows) of the EE attractor, the three
# identity leaves and the grouped obstacle policy (70 rows)
K1_FLAGSHIP_LAYOUT = (("dense", 3), ("identity", 0), ("identity", 0),
                      ("identity", 0), ("scalar", 70))


@spent()
def k1_layout_blocks(seed: int, B: int, n: int, layout, device):
    """Seeded blocks of `layout`, a sequence of (tag, rows): dense blocks
    with W = S J (S SPD), identity blocks with SPD metrics, scalar blocks
    with non-negative metrics."""
    rng = np.random.default_rng(seed)

    def spd(d):
        L = rng.normal(size=(B, d, d)) * 0.3
        return L @ L.transpose(0, 2, 1) + 0.5 * np.eye(d)

    blocks = []
    for tag, R in layout:
        if tag == "identity":
            blk = (spd(n), rng.normal(size=(B, n)))
        elif tag == "dense":
            J = rng.normal(size=(B, R, n))
            blk = (J, spd(R) @ J, rng.normal(size=(B, R)))
        else:
            blk = (rng.normal(size=(B, R, n)) * 0.3,
                   rng.uniform(0.0, 2.0, (B, R)), rng.normal(size=(B, R)))
        blocks.append(tuple(torch.tensor(np.asarray(x, np.float32),
                                         device=device) for x in blk))
    return tuple(tag for tag, _ in layout), blocks


@spent()
def k1_compare(tags, blocks, what: str, nonfinite_ok: bool = False) -> float:
    """Max |kernel - plain| of K1 on the blocks, held to K1_TOL x
    max(1, |q̈|). nonfinite_ok: envs whose plain q̈ is not finite (a real
    tick of the randomized scene can put a velocity-cap metric at its
    singularity, |q̇| = max_velocity - 2 region, where both packages give a
    non-finite q̈ and the max_qdd guard zeros it) are left out of the
    comparison and counted; the kernel must be finite wherever the plain
    version is."""
    got = cuda_resolve.pullback_resolve_structured(tags, blocks)
    want = cuda_resolve.pullback_resolve_structured_plain(tags, blocks)
    torch.cuda.synchronize()
    finite = torch.isfinite(want).all(dim=1)
    bad = int((~finite).sum())
    both = int((~finite & ~torch.isfinite(got).all(dim=1)).sum())
    keep = finite[:, None]
    err = float((got - want).masked_fill(~keep, 0.0).abs().max())
    scale = max(1.0, float(want.masked_fill(~keep, 0.0).abs().max()))
    log(f"K1 {what}: max|kernel - plain| {err:.3e} (limit "
        f"{K1_TOL * scale:.3e}, max|q̈| {scale:.3e})"
        + (f"; {bad} envs with a non-finite plain q̈, the kernel's non-finite "
           f"there too on {both}" if bad else ""))
    check(nonfinite_ok or bad == 0, f"K1 {what}: non-finite plain q̈")
    check(bool(torch.isfinite(got[finite]).all()),
          f"K1 {what}: non-finite output")
    check(err <= K1_TOL * scale, f"K1 {what}: disagrees with plain version")
    return err


@spent()
def real_tick_blocks(env, B: int, seed: int):
    """Structured blocks of one real tick of the scene `env`, from mildly
    perturbed reset states (so the envs differ)."""
    rng = np.random.default_rng(seed)
    states = envs.make_batched_reset(env, B)()
    dev, n = states.sim.q.device, env.model.n_q
    dq = torch.tensor(rng.uniform(-0.05, 0.05, (B, n)), dtype=torch.float32,
                      device=dev)
    dqd = torch.tensor(rng.uniform(-0.05, 0.05, (B, n)), dtype=torch.float32,
                       device=dev)
    sim = dataclasses.replace(states.sim, q=states.sim.q + dq, qd=dqd)
    states = dataclasses.replace(states, sim=sim)
    q, qd, params, ctxs, fk = _policy_inputs(env, states, env.gather_params())
    return policy_row_blocks_structured(env.policies, q, qd, params, ctxs,
                                        fk=fk)


def build_counts(source: str, what: str, kernel: str | None = None) -> dict:
    build = ptxas_counts(source, kernel)
    log(f"{what} build ({source}{', ' + kernel if kernel else ''}): "
        f"{json.dumps(build)}")
    check(build["registers"] is not None, f"{what}: no ptxas line in build.log")
    return build


@spent()
def warm_dispatch() -> None:
    """K1 through its op on tiny CPU blocks (the plain version): what the
    first call of a process imports and sets up, without the card."""
    cuda_resolve.pullback_resolve_structured(*k1_layout_blocks(
        1, 1, 9, K1_FLAGSHIP_LAYOUT, torch.device("cpu")))


def phase_k1(env, device) -> dict:
    build = build_counts("pullback_resolve.cu", "K1",
                         "pullback_resolve_kernelILi9E")
    # the process's first kernel call (the library's load and its first
    # launch), apart from the comparisons' seconds
    with part("K1 library load"):
        _build.load()
    with part("K1 first call"):
        cuda_resolve.pullback_resolve_structured(*k1_layout_blocks(
            1, 1, 9, K1_FLAGSHIP_LAYOUT, device))
        torch.cuda.synchronize()
    err, real = 0.0, {}
    for B in (BATCH,) + RAGGED:
        tags, blocks = k1_layout_blocks(0 if B == BATCH else B, B, 9,
                                        K1_FLAGSHIP_LAYOUT, device)
        err = max(err, k1_compare(tags, blocks,
                                  f"random contiguous blocks, B={B}"))
        real[B] = real_tick_blocks(env, B, 1)
        check(real[B][0] == tags, f"unexpected flagship tags {real[B][0]}")
        err = max(err, k1_compare(*real[B], f"real tick, B={B}"))
    rtags, rblocks = real[BATCH]
    layout = {f"{t} {k}": blk[0].stride() for k, (t, blk) in
              enumerate(zip(rtags, rblocks)) if t != "identity"}
    log(f"K1 real tick at B={BATCH}: J strides {layout}")
    check(not rblocks[-1][0].is_contiguous(),
          "K1 real tick: the scalar block's J is no longer a strided view")

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

    def call():
        return cuda_resolve.pullback_resolve_structured(rtags, rblocks)
    per_call = device_launches(call, "pullback_resolve_kernel", "K1")
    log(f"K1 wrapper on the real blocks: {per_call} device launch(es) per "
        f"call")
    check(per_call == 1, "K1: not one launch per wrapper call")
    ms, device_ms = time_ms(call), time_ms(call, lead=True)
    plain_ms = time_ms(
        lambda: cuda_resolve.pullback_resolve_structured_plain(rtags, rblocks))
    library_ms = time_ms(lambda: k1_library(rtags, rblocks))
    b_ms, b_by = k1_bound(rtags, rblocks)
    log(f"K1 times at B={BATCH}: wrapper {ms:.4f} ms (device alone "
        f"{device_ms:.4f} ms), plain {plain_ms:.4f} ms, einsum+linalg.solve "
        f"{library_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    return dict(name="pullback_resolve_structured", route="cuda",
                source="rmp_tpu_torch/csrc/pullback_resolve.cu",
                replaces="rmp_tpu/ops/pallas_resolve.py:226",
                max_abs_err=err, ms=ms, device_ms=device_ms,
                device_launches_per_call=per_call, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                build=build)


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


def k2_operands(B: int, device):
    """(J, W, v), their batch-minor copies (Jt, Wt, vt) and K2b's three row
    slices (Js, Ws, vs), at R = 30."""
    J, W, v = k2_rows(5 if B == BATCH else B, B, device=device)
    Jt, Wt, vt = (x.permute(*reversed(range(x.dim()))).contiguous()
                  for x in (J, W, v))
    cuts = ((0, 3), (3, 23), (23, 30))
    Js, Ws, vs = ([x[:, a:b] for a, b in cuts] for x in (J, W, v))
    return (J, W, v), (Jt, Wt, vt), (Js, Ws, vs)


def phase_k2(device) -> tuple[dict, dict]:
    err_a = err_b = 0.0
    for B in (BATCH,) + RAGGED:
        (J, W, v), (Jt, Wt, vt), (Js, Ws, vs) = k2_operands(B, device)
        err_a = max(
            err_a,
            k2_compare(cuda_resolve.pullback_resolve(J, W, v),
                       cuda_resolve.pullback_resolve_plain(J, W, v),
                       f"K2a pullback_resolve, ridge 1e-6, B={B}"),
            k2_compare(cuda_resolve.pullback_resolve_t(Jt, Wt, vt),
                       cuda_resolve.pullback_resolve_t_plain(Jt, Wt, vt),
                       f"K2a pullback_resolve_t, ridge 1e-6, B={B}"))
        err_b = max(err_b, k2_compare(
            cuda_resolve.pullback_resolve_blocks(Js, Ws, vs),
            cuda_resolve.pullback_resolve_blocks_plain(Js, Ws, vs),
            f"K2b pullback_resolve_blocks (3 blocks), ridge 0, B={B}"))
    (J, W, v), (Jt, Wt, vt), (Js, Ws, vs) = k2_operands(BATCH, device)
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
        ms, device_ms = time_ms(fn), time_ms(fn, lead=True)
        plain_ms = time_ms(plain)
        log(f"{name} times at B={BATCH}, R=30: wrapper {ms:.4f} ms (device "
            f"alone {device_ms:.4f} ms), plain {plain_ms:.4f} ms, "
            f"einsum+linalg.solve {library_ms:.4f} ms, bound {b_ms:.6f} ms "
            f"({b_by})")
        recs.append(dict(name=name, route="cuda",
                         source="rmp_tpu_torch/csrc/pullback_resolve.cu",
                         replaces=f"rmp_tpu/ops/pallas_resolve.py:{src_line}",
                         max_abs_err=err, ms=ms, device_ms=device_ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=library_ms))
    recs[0]["t_ms"] = time_ms(lambda: cuda_resolve.pullback_resolve_t(Jt, Wt,
                                                                       vt))
    return recs[0], recs[1]


# ---------------------------------------------------------------- K3 ------

def k3_flops(model) -> int:
    """Flops per env of the kernel's 4x4 products (112 flops each) and
    element-wise updates."""
    mm = 112
    flops = 0
    for f in range(model.n_frames):
        flops += 2 * mm + mm + (2 * mm + 16)       # A, T; Td; c
        if model.joint_type[f] != FIXED:
            flops += 2 * mm + 18 + 32 + 2 * mm + 48  # G, inverse, W, Wd
        flops += mm * sum(1 for j in model.chain(f)
                          if model.joint_type[j] != FIXED)
    return flops


def k3_bound(model, B: int):
    """Bound of the kernel: reads q, qd and writes T, Td, c (16 floats
    each) and J (16 n) per frame, once; k3_flops per env."""
    n, F = model.n_q, model.n_frames
    floats = 2 * n + F * 16 * (3 + n)
    return bound_ms(4.0 * floats * B, float(k3_flops(model)) * B)


def k3_inputs(model, B: int, device):
    rng = np.random.default_rng(3 if B == BATCH else 3 + B)
    return tuple(torch.tensor(rng.uniform(-a, a, (B, model.n_q)),
                              dtype=torch.float32, device=device)
                 for a in (1.2, 1.0))


def phase_k3(device) -> dict:
    model = robots.franka_panda()
    build = build_counts("fk_derivatives.cu", "K3")
    shared = _build.c_function("rmp_fk_derivatives_shared_bytes",
                               [ctypes.c_int, ctypes.c_int])
    build["dynamic_smem_bytes"] = shared(model.n_frames, model.n_q)
    log(f"K3 dynamic shared memory per CTA: {build['dynamic_smem_bytes']} "
        f"bytes")
    err = 0.0
    for B in (BATCH,) + RAGGED:
        q, qd = k3_inputs(model, B, device)
        got = cuda_fk.fk_derivatives_batched(model, q, qd)
        want = fk_derivatives(model, q, qd)
        torch.cuda.synchronize()
        for name, g, w in zip(("T16", "Td16", "J16", "c16"), got, want):
            check(g.shape == w.shape,
                  f"K3 {name}: shape {g.shape} vs {w.shape}")
            e = float((g - w).abs().max())
            log(f"K3 {name}, B={B}: max|kernel - plain| {e:.3e} "
                f"(atol {K3_ATOL})")
            check(e <= K3_ATOL, f"K3 {name}: disagrees with plain version")
            err = max(err, e)
    q, qd = k3_inputs(model, BATCH, device)

    def call():
        return cuda_fk.fk_derivatives_batched(model, q, qd)
    per_call = device_launches(call, "fk_derivatives_kernel", "K3")
    log(f"K3 wrapper: {per_call} device launch(es) per call")
    check(per_call == 1, "K3: not one launch per wrapper call")
    ms, device_ms = time_ms(call), time_ms(call, lead=True)
    plain_ms = time_ms(lambda: fk_derivatives(model, q, qd))
    b_ms, b_by = k3_bound(model, BATCH)
    log(f"K3 times at B={BATCH}: wrapper {ms:.4f} ms (device alone "
        f"{device_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms "
        f"({b_by})")
    return dict(name="fk_derivatives_batched", route="cuda",
                source="rmp_tpu_torch/csrc/fk_derivatives.cu",
                replaces="rmp_tpu/ops/pallas_fk.py:218",
                max_abs_err=err, ms=ms, device_ms=device_ms,
                device_launches_per_call=per_call, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None, build=build)


# ---------------------------------------------------------------- K4 ------

K4_SUPPORT_VERTEX_FLOPS = 10   # dot (3 mul, 2 add), compare, 4 accumulates
K4_VERTEX_FLOPS_NEEDED = 6     # dot (3 mul, 2 add) and the max
K4_SUPPORT_FIXED_FLOPS = 37    # R^T d, 1 / count and scale, R s + t
K4_OBSTACLE_FLOPS = 50         # both obstacle supports and the select
K4_JOHNSON_NEWEST_FLOPS = 470  # Gram 50, 1 single, 3 pairs, 3 triples, tet
K4_JOHNSON_FULL_FLOPS = 650    # Gram 50, 4 singles, 6 pairs, 4 triples, tet
K4_STEP_FLOPS = 30             # gap test, eviction and slot selects


def k4_bound(ops: dict, iters: int):
    """Bound of one K4 call by the first count: reads the hull tables, each
    (link, env) pose (12 floats) and each pair's operands (14 floats) once
    and writes 7 floats per pair; flops per pair by the counts above, every
    iteration of every pair, V vertices per support."""
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


def k4_bound_needed(ops: dict, needed: torch.Tensor):
    """Bound of one K4 call from the least arithmetic its outputs need: the
    bytes of k4_bound; per support a dot and a max per distinct vertex of
    the link (cuda_gjk.distinct_rows), and per pair only the iterations
    `needed` (L, M, B) until it freezes (k4_needed_iterations)."""
    L, V, _ = ops["verts"].shape
    M, B = ops["p0"].shape[1], ops["p0"].shape[3]
    rows = torch.tensor(cuda_gjk.distinct_rows(ops["verts"]),
                        dtype=torch.float64)
    hull = K4_VERTEX_FLOPS_NEEDED * rows + K4_SUPPORT_FIXED_FLOPS   # (L,)
    n = needed.double().cpu()
    flops = float(((hull[:, None, None] + K4_OBSTACLE_FLOPS) * (1 + n)
                   + (K4_JOHNSON_NEWEST_FLOPS + K4_STEP_FLOPS) * n
                   + K4_JOHNSON_FULL_FLOPS + 30).sum())
    floats = L * V * 3 + L * B * 12 + L * M * B * (14 + 7)
    return bound_ms(4.0 * floats, flops)


def k4_needed_iterations(ops: dict, iters: int):
    """(needed (L, M, B), live share per iteration) of a K4 call, from plain
    runs at 0..iters + 1 iterations. A pair whose outputs move between
    i - 1 and i iterations was live at iteration i; it needs the iterations
    up to its last move and one more, whose gap test freezes it (at most
    `iters`). live[i] is the share of pairs whose outputs still move
    between i and i + 1 iterations, i = 1..iters."""
    outs = [cuda_gjk.gjk_hull_obstacles_plain(**ops, iters=i)
            for i in range(iters + 2)]

    def moved(a, b):
        return ((a[0] != b[0]).any(dim=2) | (a[1] != b[1]).any(dim=2)
                | (a[2] != b[2]))
    last = torch.zeros_like(outs[0][2], dtype=torch.long)
    for i in range(1, iters + 1):
        last = torch.where(moved(outs[i - 1], outs[i]),
                           torch.full_like(last, i), last)
    needed = torch.clamp(last + 1, max=iters)
    live = {i: float(moved(outs[i], outs[i + 1]).double().mean())
            for i in range(1, iters + 1)}
    return needed, live


def k4_compare(got, want, what: str, witness_quantile: bool = True) -> dict:
    """Quantile agreement of K4 outputs (pa, pb, dist) with the plain
    version's: the distances, and where they agree the witnesses. With
    witness_quantile False the witnesses are held at the max only, and the
    caller holds every pair's Minkowski point to its ball (k4_evidence)
    where their p99 is missed: a pair the fixed iteration count leaves
    short of convergence may end anywhere within its ball, with distances
    that agree to second order, and scenes of random cylinders leave more
    than 1% of the pairs of a 128-env call so."""
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
    rec["witness_quantile_met"] = rec["witness_p99"] < K4_WITNESS_P99
    check((rec["witness_quantile_met"] or not witness_quantile)
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


@spent()
def k4_evidence(ops, got, plain, what: str, cap_fault: bool = False) -> dict:
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
    cap_fault (the randomized scene's randomly tilted cylinders): the
    checks take the form that the reference's own cap fault allows, where
    it shows on more pairs than the flagship's limits (ROADMAP Queue 3):
    the balls hold the pairs but the cylinders met on their end caps
    (whose iterates may leave the shape without falling below lo; their
    excess is recorded), the far share counts the pairs on the shape, and
    the kernel may stay apart from float64 on no more pairs than the plain
    version (plus K4_FAR_SHARE of them), each a cylinder pair.
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
    # a cylinder met on its end cap: the nearest point's direction within
    # ~8 degrees of the axis, where the reference's support can leave the
    # shape
    cap_contact = cyl & (axis_cos > K4_CAP_COS)

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
        ball_excess=umax(norm(x_k - x_ref) - r(d_k) - r(d_ref),
                         on & ~cap_contact if cap_fault else on),
        ball_excess_cap_contact=umax(norm(x_k - x_ref) - r(d_k) - r(d_ref),
                                     on & cap_contact),
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
        tail_converged_dwitness=umax(wdiff(conv, ref), tail & ~apart),
        far_on_shape_share=float((~off & (ddist > K4_FAR)).double().mean()),
        converged_apart_not_cylinder=int((apart & ~cyl).sum()),
        converged_plain_apart_not_cylinder=int((apart_plain & ~cyl).sum()))
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
    if cap_fault:
        # the reference's float32 cylinder support leaves the end cap (ROADMAP
        # Queue 3) on more of these pairs than the flagship's limits allow,
        # in the plain version as in the kernel: such off-shape pairs may
        # part, and the kernel stays apart from float64 on no more pairs
        # than the plain version, every one of them a cylinder pair
        check(rec["far_on_shape_share"] <= K4_FAR_SHARE,
              f"{what}: too many pairs on the shape part by more than "
              f"{K4_FAR}")
        check(int(apart.sum()) <= int(apart_plain.sum())
              + K4_FAR_SHARE * n_used,
              f"{what}: the kernel stays apart from the float64 reference "
              f"on more pairs than the plain version")
        check(rec["converged_apart_not_cylinder"] == 0
              and rec["converged_plain_apart_not_cylinder"] == 0,
              f"{what}: a capsule pair stays apart from the float64 "
              f"reference")
        return rec
    check(rec["far_share"] <= K4_FAR_SHARE,
          f"{what}: too many pairs part by more than {K4_FAR}")
    check(max(int(apart.sum()), int(apart_plain.sum())) / n_used
          <= K4_CONVERGED_SHARE,
          f"{what}: too many pairs stay apart from the float64 reference")
    return rec


def k4_main_path_operands(scene: str = SCENE, method: str | None = "solve",
                          ticks: int = 20):
    """(operands, iters) of a hull main path's own K4 call: `scene` (resolve
    `method`, None the scene's own) in the hull tier at BATCH envs, reset
    and rolled `ticks` ticks, then collision.gjk_operands on its state with
    its gjk_warm carry (what the next tick's call gets: in a scene with an
    update_scene, the carry of the obstacles' previous positions) and the
    warm iteration count the path runs."""
    env = envs.make(scene)
    if method is not None:
        env.resolve_method = method
    env.collision_geometry = "hull"
    states = envs.make_batched_reset(env, BATCH)()
    states, _ = envs.make_batched_rollout(env, ticks, with_aux=False)(
        states, env.gather_params())
    T_all = kinematics.fk_all(env.model, states.sim.q)
    obstacles = states.sim.obstacles
    cap = collision.robot_obstacle_distances(env.model, T_all, obstacles)
    _, ops = collision.gjk_operands(env.model, T_all, obstacles, cap,
                                    warm=states.gjk_warm)
    return ops, env.hull_warm_iters or data.WARM_ITERS


def k4_slice(ops: dict, B: int) -> dict:
    """The operands of the first B envs, contiguous."""
    return {k: v if k == "verts" else v[..., :B].contiguous()
            for k, v in ops.items()}


def phase_k4(env, device) -> dict:
    build = build_counts("gjk_hull.cu", "K4")
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
        rec["ms"], rec["device_ms"] = time_ms(run), time_ms(run, lead=True)
        rec["plain_ms"] = time_ms(plain, reps=5)
        rec["bound_ms"], rec["bound_by"] = k4_bound(ops, iters)
        log(f"K4 {mode} times at {tuple(ops['p0'].shape[:2])} x {BATCH} "
            f"pairs: kernel {rec['ms']:.4f} ms (device alone "
            f"{rec['device_ms']:.4f} ms), plain {rec['plain_ms']:.4f} ms, "
            f"bound {rec['bound_ms']:.5f} ms ({rec['bound_by']}, every "
            f"iteration of every pair, the first count)")
        out[mode] = rec

    # ragged batches: against the plain version, and bit for bit the
    # 4096-env call's first B envs (the tail's envs compute and store nothing)
    full = cuda_gjk.gjk_hull_obstacles(**cold_ops, iters=10)
    err = max(out["cold"]["dist_max"], out["warm"]["dist_max"])
    for B in RAGGED:
        ops = k4_slice(cold_ops, B)
        got = cuda_gjk.gjk_hull_obstacles(**ops, iters=10)
        rec = k4_compare(got, cuda_gjk.gjk_hull_obstacles_plain(**ops,
                                                                iters=10),
                         f"K4 cold 10 iterations, B={B}")
        same = all(bool(torch.equal(g, f[..., :B]))
                   for g, f in zip(got, full))
        log(f"K4 B={B}: equal to the first {B} envs of the B={BATCH} call: "
            f"{same}")
        check(same, f"K4 B={B}: differs from the B={BATCH} call")
        err = max(err, rec["dist_max"])

    # the hull main path's own warm operands: the call the redesign is
    # judged on
    ops, iters = k4_main_path_operands()

    def call():
        return cuda_gjk.gjk_hull_obstacles(**ops, iters=iters)

    def plain():
        return cuda_gjk.gjk_hull_obstacles_plain(**ops, iters=iters)
    main = k4_compare(call(), plain(), f"K4 main-path operands, {iters} "
                      f"iterations")
    # early exit: on the main path's operands (a warp's 32 envs hold the
    # same pair) the first half of the envs starts at each pair's Minkowski
    # point x* = pa - pb of a 64-iteration run, where many pairs, so whole
    # warps, freeze at iteration 1; the rest keep the path's warm start
    pa, pb, _ = cuda_gjk.gjk_hull_obstacles(**ops, iters=64)
    half = BATCH // 2
    d0 = ops["d0"].clone()
    d0[..., :half] = (pa - pb)[..., :half]
    mixed = dict(ops, d0=d0.contiguous())
    one, two = (cuda_gjk.gjk_hull_obstacles_plain(**mixed, iters=i)
                for i in (1, 2))
    frozen = ((one[0] == two[0]).all(dim=2) & (one[1] == two[1]).all(dim=2)
              & (one[2] == two[2]))
    log(f"K4 mixed batch: share of pairs frozen at iteration 1, envs "
        f"[0, {half}) {float(frozen[..., :half].double().mean()):.4f}, the "
        f"rest {float(frozen[..., half:].double().mean()):.4f}")
    rec = k4_compare(cuda_gjk.gjk_hull_obstacles(**mixed, iters=10),
                     cuda_gjk.gjk_hull_obstacles_plain(**mixed, iters=10),
                     "K4 mixed batch, 10 iterations")
    err = max(err, rec["dist_max"])

    per_call = device_launches(call, "gjk_hull_kernel", "K4")
    log(f"K4 wrapper: {per_call} device launch(es) per call")
    check(per_call == 1, "K4: not one launch per wrapper call")
    needed, live = k4_needed_iterations(ops, iters)
    main.update(iters=iters, ms=time_ms(call), device_ms=time_ms(call,
                                                                 lead=True),
                plain_ms=time_ms(plain, reps=5), live_share=live,
                mean_needed_iterations=float(needed.double().mean()),
                distinct_rows=cuda_gjk.distinct_rows(ops["verts"]))
    main["bound_ms"], main["bound_by"] = k4_bound_needed(ops, needed)
    main["bound_ms_every_iteration"], _ = k4_bound(ops, iters)
    log(f"K4 main-path operands ({SCENE}, hull, {BATCH} envs, 20 ticks in, "
        f"warm, {iters} iterations): share of pairs still changing after "
        f"iteration i {json.dumps(live)}, mean iterations needed "
        f"{main['mean_needed_iterations']:.4f}")
    log(f"K4 main-path times: kernel {main['ms']:.4f} ms (device alone "
        f"{main['device_ms']:.4f} ms), plain {main['plain_ms']:.4f} ms, bound "
        f"{main['bound_ms']:.6f} ms ({main['bound_by']}: the supports and "
        f"iterations each pair needs, 6 flops per distinct vertex "
        f"{main['distinct_rows']}); by the first count "
        f"{main['bound_ms_every_iteration']:.6f} ms")
    return dict(name="gjk_hull_obstacles", route="cuda",
                source="rmp_tpu_torch/csrc/gjk_hull.cu",
                replaces="rmp_tpu/ops/pallas_gjk.py:318",
                max_abs_err=max(err, main["dist_max"]), ms=main["ms"], device_ms=main["device_ms"],
                device_launches_per_call=per_call, plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=None, build=build, main_path_operands=main,
                cold=out["cold"], warm=out["warm"])


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


def ptxas_counts(source: str, kernel: str | None = None) -> dict:
    """Registers, static shared memory, stack frame and spill bytes of
    `source` from build.log (the largest over its kernels, or over those
    whose name holds `kernel`); a header's kernels are looked for in every
    source's lines."""
    text = _build.build_log()
    if not source.endswith(".cuh"):
        text = text.split(f"== {source}\n", 1)[-1].split("\n== ")[0]
    if kernel is not None:
        text = "\n".join(c for c in text.split("Compiling entry function")
                         if kernel in c.split("\n", 1)[0])

    def num(pattern):
        found = re.findall(pattern, text)
        return max(int(v) for v in found) if found else None
    return dict(registers=num(r"Used (\d+) registers"),
                smem_bytes=num(r"(\d+) bytes smem"),
                stack_bytes=num(r"(\d+) bytes stack frame"),
                spill_store_bytes=num(r"(\d+) bytes spill stores"),
                spill_load_bytes=num(r"(\d+) bytes spill loads"))


def k5_check(what: str, err: torch.Tensor, limit: float) -> float:
    worst = float(err.max())
    log(f"K5 {what}: max|Δq̈| / max(1, |q̈|) {worst:.3e} (limit {limit})")
    check(worst <= limit, f"K5 {what}: disagrees")
    return worst


def phase_k5(device) -> dict:
    build = build_counts("fused_tick.cuh", "K5", "fused_qdd_kernelI")
    shared = _build.c_function("rmp_fused_qdd_shared_bytes",
                               [ctypes.c_int] * 3)
    rec = dict(name="fused_qdd", route="cuda",
               source="rmp_tpu_torch/csrc/fused_tick.cu",
               replaces="rmp_tpu/ops/pallas_tick.py:421", build=build)
    err = 0.0
    for scene, tag in ((SCENE, "06"), (SCENE05, "05")):
        env = envs.make(scene)
        tick = cuda_tick.fused_tick(env)
        fn = cuda_tick.make_fused_qdd(env)
        smem = shared(tick.model.n_frames, tick.model.n_q,
                      len(tick.col_frames))
        build[f"dynamic_smem_bytes_scene{tag}"] = smem
        log(f"K5 {tag} dynamic shared memory per CTA: {smem} bytes")
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

        for B in RAGGED:
            args = tuple(x[:B].contiguous() for x in near)
            got_b = fn(*args)
            check(bool(torch.isfinite(got_b).all()),
                  f"K5 {tag} B={B}: non-finite")
            err = max(err, k5_check(f"{tag} near ready, kernel vs plain, "
                                    f"B={B}", k5_rel(got_b, plain(*args)),
                                    K1_TOL))

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
        per_call = device_launches(lambda: fn(*near), "fused_qdd_kernel",
                                   f"K5 {tag}")
        log(f"K5 {tag} wrapper: {per_call} device launch(es) per call")
        check(per_call == 1, "K5: not one launch per wrapper call")
        times = dict(ms=time_ms(lambda: fn(*near)),
                     device_ms=time_ms(lambda: fn(*near), lead=True),
                     plain_ms=time_ms(lambda: plain(*near), reps=5),
                     standard_ms=time_ms(standard))
        b_ms, b_by = k5_bound(tick, BATCH, K)
        total, mirrored = tick_ops.fused_qdd_ops(tick, K)
        log(f"K5 {tag} times at B={BATCH}, K={K}: kernel {times['ms']:.4f} "
            f"ms (device alone {times['device_ms']:.4f} ms), plain "
            f"{times['plain_ms']:.4f} ms, standard q̈ evaluation "
            f"(FK + context + blocks + K1) {times['standard_ms']:.4f} ms, "
            f"bound {b_ms:.6f} ms ({b_by}, {total - mirrored} operations "
            f"per env: the reference body's {total} less {mirrored} on A's "
            f"mirrored upper triangle)")
        rec[f"scene{tag}"] = dict(
            K=K, wide_compared=n_held, full_model_gap=gap,
            device_launches_per_call=per_call, bound_ms=b_ms,
            bound_by=b_by, ops_per_env=total - mirrored,
            reference_ops_per_env=total, **times)
    main = rec["scene06"]
    # no single PyTorch call computes the fused tick
    rec.update(max_abs_err=err, ms=main["ms"], device_ms=main["device_ms"],
               device_launches_per_call=main["device_launches_per_call"],
               plain_ms=main["plain_ms"],
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


@spent()
def phase_main_path(card: str, geometry: str, scene: str = SCENE,
                    ticks: int = TICKS, method: str | None = "solve"
                    ) -> tuple[dict, dict]:
    """A BATCH-env rollout of `scene` in `geometry` for `ticks` ticks, with
    resolve `method` (None: the scene's own), every launch counter zeroed
    just before it and read after: each kernel of the path once per tick
    (K1 only where the scene resolves with 'solve'), every other counter 0.
    Then its 10-tick trace."""
    what = ("main path" if geometry == "capsule" else "hull main path") \
        if scene == SCENE else f"{scene} ({geometry}) path"
    env = envs.make(scene)                   # the GPU by default
    if method is not None:
        env.resolve_method = method
    env.collision_geometry = geometry
    path_kernels = tuple(k for k in PATH_KERNELS[geometry]
                         if env.resolve_method == "solve"
                         or k != "pullback_resolve_structured")
    params = env.gather_params()
    states = envs.make_batched_reset(env, BATCH)()
    states, _ = envs.make_batched_rollout(env, WARMUP_TICKS,
                                          with_aux=False)(states, params)
    rollout = envs.make_batched_rollout(env, ticks, with_aux=False)
    torch.cuda.synchronize()
    for fn in COUNTERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    final, _ = rollout(states, params)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    steps_per_s = BATCH * ticks / seconds
    log(f"{what}: {scene} ({geometry}, '{env.resolve_method}'), {BATCH} envs "
        f"x {ticks} ticks in {seconds:.3f} s = {steps_per_s:.1f} control "
        f"steps/s [{card}]")
    log(f"{what} launches: {launches}")
    check(bool(torch.isfinite(final.sim.q).all()), f"{what}: non-finite q")
    check(tuple(final.sim.q.shape) == (BATCH, env.model.n_q),
          f"{what}: q shape")
    for name, count in launches.items():
        want = ticks if name in path_kernels else 0
        check(count == want, f"{what}: {name} launched {count} times in "
              f"{ticks} ticks, want {want}")
    solved = int(final.solved_count.sum())
    log(f"{what}: goals reached over the batch {solved}, "
        f"mean phase {float(final.phase.float().mean()):.3f}")
    trace = profile_ticks(env, final, params, seconds * 1e3 / ticks)
    log(f"{what} trace: {json.dumps(trace)}")
    return launches, dict(scene=scene, geometry=geometry,
                          resolve_method=env.resolve_method, envs=BATCH,
                          ticks=ticks, seconds=seconds,
                          control_steps_per_s=steps_per_s,
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


@spent()
def profile_ticks(env, states, params, tick_ms: float,
                  n_ticks: int = PROFILE_TICKS) -> dict:
    """n_ticks ticks under torch.profiler: device busy ms per tick
    (union of kernel intervals), the idle share of the unprofiled tick
    (tick_ms) and of the traced span (which the profiler stretches), device
    launches per tick, the port's own kernels' device time, and the
    kernels with the most device time."""
    step = envs.make_batched_control_step(env)

    def ticks(n: int) -> None:
        nonlocal states
        for _ in range(n):
            states, _ = step(states, params)

    for attempt in range(1, TRACE_ATTEMPTS + 1):
        kernels = device_kernels(traced(lambda: ticks(n_ticks),
                                        warm=lambda: ticks(1),
                                        host_ops=False))
        if kernels:
            break
        log(f"main path trace {attempt}: no device activity recorded")
    TRACE_TRIES.append(("profile_ticks", attempt))
    check(bool(kernels), "main path trace: no device activity recorded")
    by_name: dict[str, list] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    top = sorted(((sum(v), len(v), k) for k, v in by_name.items()),
                 reverse=True)[:10]
    busy_ms = _busy_us(kernels) / 1e3 / n_ticks
    span_ms = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels)) / 1e3 / n_ticks
    return dict(
        ticks=n_ticks, tick_ms=tick_ms,
        device_launches_per_tick=len(kernels) / n_ticks,
        device_busy_ms_per_tick=busy_ms,
        device_idle_share=1.0 - busy_ms / tick_ms,
        device_idle_share_traced=1.0 - busy_ms / span_ms,
        port_kernels_us_per_tick={
            k[:60]: sum(v) / n_ticks for k, v in by_name.items()
            if any(n in k for n in ("pullback_resolve_kernel",
                                    "pullback_resolve_wide_kernel",
                                    "pullback_resolve_cta_kernel",
                                    "fk_derivatives_kernel",
                                    "gjk_hull_kernel"))},
        top_kernels=[dict(name=k[:80], us_per_tick=t / n_ticks,
                          launches_per_tick=c / n_ticks)
                     for t, c, k in top])


def perturbed_states(env, B: int, seed: int, dq: float, dqd: float,
                     ulp: bool = False):
    """Reset states moved by q ± dq, q̇ ± dqd (seeded); with ulp, q and q̇
    then move up by one ulp."""
    rng = np.random.default_rng(seed)
    states = envs.make_batched_reset(env, B)()
    dev, n = states.sim.q.device, env.model.n_q
    q = states.sim.q + torch.tensor(rng.uniform(-dq, dq, (B, n)),
                                    dtype=torch.float32, device=dev)
    qd = torch.tensor(rng.uniform(-dqd, dqd, (B, n)), dtype=torch.float32,
                      device=dev)
    if ulp:
        up = torch.tensor(float("inf"), device=dev)
        q, qd = torch.nextafter(q, up), torch.nextafter(qd, up)
    return dataclasses.replace(states, sim=dataclasses.replace(
        states.sim, q=q, qd=qd))


@spent(by="dev")
def parity_q(dev: str, dq: float, dqd: float, ulp: bool = False,
             geometry: str = "capsule", B: int = 128, scene: str = SCENE,
             method: str | None = "solve", torque: bool = False,
             solved: bool = False, warm_iters: int | None = None):
    """q after 5 ticks of `scene` on `dev` from perturbed reset states;
    method None keeps the scene's resolve method; warm_iters sets the hull
    tier's warm GJK iterations (None: the scene's). With `solved`, also the
    (B,) flags of envs that reached a goal in those ticks (where the GPU's
    and the CPU's random resampling part)."""
    env = envs.make(scene, device=dev)
    if method is not None:
        env.resolve_method = method
    env.collision_geometry = geometry
    env.torque_mode = torque
    env.hull_warm_iters = warm_iters or env.hull_warm_iters
    final, aux = envs.make_batched_rollout(env, 5, with_aux=solved)(
        perturbed_states(env, B, 4, dq, dqd, ulp), env.gather_params())
    if solved:
        return final.sim.q.cpu(), aux["solved"].any(dim=1).cpu()
    return final.sim.q.cpu()


def phase_parity() -> dict:
    # near the ready pose every env is well conditioned
    err = float((parity_q("cuda", 0.1, 0.05)
                 - cpu_run(parity_q, "cpu", 0.1, 0.05)).abs().max())
    log(f"parity: 128 envs x 5 ticks from q ± 0.1, q̇ ± 0.05, "
        f"max|q_gpu - q_cpu| {err:.3e} (atol {PARITY_ATOL})")
    check(err <= PARITY_ATOL, "GPU/CPU parity")

    # from q ± 0.3, q̇ ± 0.5 envs that reach the velocity cap's clip amplify
    # rounding (tests/test_torch_conditioning.py): held where the CPU run
    # itself is insensitive to a one-ulp move of its start
    cpu = cpu_run(parity_q, "cpu", 0.3, 0.5)
    sens = (cpu_run(parity_q, "cpu", 0.3, 0.5, ulp=True)
            - cpu).abs().amax(dim=1)
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
                     - cpu_run(parity_q, "cpu", 0.1, 0.05, geometry="hull",
                               B=B)).abs().max())
        log(f"hull parity: {B} envs x 5 ticks from q ± 0.1, q̇ ± 0.05, "
            f"max|q_gpu - q_cpu| {err:.3e} (atol {PARITY_ATOL})")
        check(err <= PARITY_ATOL, f"hull GPU/CPU parity at B={B}")
        out[f"B{B}"] = err
    return out


def phase_scene05_parity() -> float:
    err = float((parity_q("cuda", 0.1, 0.05, scene=SCENE05)
                 - cpu_run(parity_q, "cpu", 0.1, 0.05,
                           scene=SCENE05)).abs().max())
    log(f"scene 05 parity: 128 envs x 5 ticks from q ± 0.1, q̇ ± 0.05, "
        f"max|q_gpu - q_cpu| {err:.3e} (atol {PARITY_ATOL})")
    check(err <= PARITY_ATOL, "scene 05 GPU/CPU parity")
    return err


# ------------------------------------- phase 12: the sixth slice's paths ---

SCENES_UR5 = ("ur5/01_target_reaching", "ur5/02_obstacle_avoidance")
NEW_SCENES = ("two_joint/01_target_rmp_only", "two_joint/02_jointspace_biasing",
              "two_joint/03_jointlimit_avoiding",
              "two_joint/04_driving_into_jointlimits",
              "two_joint/05_obstacle_avoidance",
              "two_joint/05_obstacle_avoidance_variant",
              "franka/01_target_rmp_only") + SCENES_UR5
# phase_new_scene_parity's default: the new scenes and franka/01 in torque
# mode, (scene, torque mode)
NEW_SCENE_RUNS = ([(s, False) for s in NEW_SCENES]
                  + [("franka/01_target_rmp_only", True)])
# K1 at n = 6 and 2: each layout (tag, rows per block) and the scene whose
# real tick has it (the UR5's scenes resolve with 'solve'; the two-joint
# robot's would at a caller's request)
K1_NEW_LAYOUTS = {
    "ur5/01": (6, (("dense", 3), ("identity", 0), ("identity", 0)),
               "ur5/01_target_reaching"),
    "ur5/02": (6, (("dense", 3), ("identity", 0), ("dense", 18)),
               "ur5/02_obstacle_avoidance"),
    "two_joint/05": (2, (("dense", 3), ("dense", 9)),
                     "two_joint/05_obstacle_avoidance"),
    "two_joint/02": (2, (("dense", 3), ("identity", 0)),
                     "two_joint/02_jointspace_biasing"),
}
GOLDEN_TOL = {"franka01": dict(qdd=2e-3, q=5e-3),
              "two_joint01": dict(q_and_qdd=5e-3),
              "franka01_torque": dict(tau=5e-3, q=5e-3)}


def phase_k1_new_n(device, layouts=None) -> tuple[dict, float]:
    """K1 on each of `layouts` (default K1_NEW_LAYOUTS: n = 6 and 2) against
    its plain version: random contiguous blocks and a real tick's blocks
    (strided views) of each layout at B = 4096, 1, 7 and 4093; one device
    kernel per call; timed at B = 4096 on the real tick's blocks beside its
    bound."""
    out, err = {}, 0.0
    for key, (n, layout, scene) in (layouts or K1_NEW_LAYOUTS).items():
        env = envs.make(scene)
        for B in (BATCH,) + RAGGED:
            tags, blocks = k1_layout_blocks(B, B, n, layout, device)
            err = max(err, k1_compare(tags, blocks, f"{key} (n={n}) random "
                                      f"contiguous blocks, B={B}"))
            rtags, rblocks = real_tick_blocks(env, B, 1)
            rows = tuple((t, b[0].shape[1] if t != "identity" else 0)
                         for t, b in zip(rtags, rblocks))
            check(rows == layout, f"K1 {key}: real tick layout {rows}")
            err = max(err, k1_compare(rtags, rblocks,
                                      f"{key} (n={n}) real tick, B={B}"))

        def call():
            return cuda_resolve.pullback_resolve_structured(rtags, rblocks)
        per_call = device_launches(call, "pullback_resolve_kernel",
                                   f"K1 {key}")
        check(per_call == 1, f"K1 {key}: not one launch per wrapper call")
        rec = dict(n=n, scene=scene, layout=[list(r) for r in layout],
                   strides={f"{t} {k}": blk[0].stride() for k, (t, blk) in
                            enumerate(zip(rtags, rblocks)) if t != "identity"},
                   device_launches_per_call=per_call, ms=time_ms(call),
                   device_ms=time_ms(call, lead=True),
                   plain_ms=time_ms(lambda: cuda_resolve.
                                    pullback_resolve_structured_plain(
                                        rtags, rblocks)),
                   library_ms=time_ms(lambda: k1_library(rtags, rblocks)))
        rec["bound_ms"], rec["bound_by"] = k1_bound(rtags, rblocks)
        log(f"K1 {key} (n={n}) times at B={BATCH} on the real tick's blocks "
            f"{rec['strides']}: wrapper {rec['ms']:.4f} ms (device alone "
            f"{rec['device_ms']:.4f} ms), plain {rec['plain_ms']:.4f} ms, "
            f"einsum+linalg.solve {rec['library_ms']:.4f} ms, bound "
            f"{rec['bound_ms']:.6f} ms ({rec['bound_by']})")
        out[key] = rec
    return out, err


def phase_k3_new_models(device) -> tuple[dict, float]:
    """K3 on the two-joint robot (F = 3, n = 2) and the UR5 (F = 7, n = 6)
    against its plain version at B = 4096, 1, 7 and 4093; one device kernel
    per call; timed at B = 4096 beside its bound."""
    shared = _build.c_function("rmp_fk_derivatives_shared_bytes",
                               [ctypes.c_int, ctypes.c_int])
    out, err = {}, 0.0
    for name, model in (("two_joint", robots.two_joint_robot()),
                        ("ur5", robots.ur5())):
        for B in (BATCH,) + RAGGED:
            q, qd = k3_inputs(model, B, device)
            got = cuda_fk.fk_derivatives_batched(model, q, qd)
            want = fk_derivatives(model, q, qd)
            torch.cuda.synchronize()
            for what, g, w in zip(("T16", "Td16", "J16", "c16"), got, want):
                check(g.shape == w.shape, f"K3 {name} {what}: shape")
                e = float((g - w).abs().max())
                log(f"K3 {name} {what}, B={B}: max|kernel - plain| {e:.3e} "
                    f"(atol {K3_ATOL})")
                check(e <= K3_ATOL, f"K3 {name} {what}: disagrees with plain "
                      f"version")
                err = max(err, e)
        q, qd = k3_inputs(model, BATCH, device)

        def call():
            return cuda_fk.fk_derivatives_batched(model, q, qd)
        per_call = device_launches(call, "fk_derivatives_kernel",
                                   f"K3 {name}")
        check(per_call == 1, f"K3 {name}: not one launch per wrapper call")
        rec = dict(frames=model.n_frames, n=model.n_q,
                   dynamic_smem_bytes=shared(model.n_frames, model.n_q),
                   device_launches_per_call=per_call, ms=time_ms(call),
                   device_ms=time_ms(call, lead=True),
                   plain_ms=time_ms(lambda: fk_derivatives(model, q, qd)))
        rec["bound_ms"], rec["bound_by"] = k3_bound(model, BATCH)
        log(f"K3 {name} (F={model.n_frames}, n={model.n_q}) times at "
            f"B={BATCH}: wrapper {rec['ms']:.4f} ms (device alone "
            f"{rec['device_ms']:.4f} ms), plain {rec['plain_ms']:.4f} ms, "
            f"bound {rec['bound_ms']:.6f} ms ({rec['bound_by']}), dynamic "
            f"shared memory {rec['dynamic_smem_bytes']} bytes")
        out[name] = rec
    return out, err


def _tree_map(fn, x):
    """fn applied to every leaf of a (nested) state or param tree, through
    its dataclasses and dicts."""
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _tree_map(fn, getattr(x,
                                                                       f.name))
                                         for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    return fn(x)


def _as_dtype(x, dtype):
    """Every floating tensor of a (nested) state or param tree as dtype."""
    return _tree_map(lambda t: t.to(dtype) if isinstance(t, torch.Tensor)
                     and t.is_floating_point() else t, x)


@contextlib.contextmanager
def plain_kernels(float64: bool = False, grad: bool = False):
    """While the block runs, the kernel wrappers of K1, K3 (the tick's, the
    randomized scene's detour IK's and the contact substeps') and K4 are
    replaced by their plain
    versions, on whatever device the tensors lie. With float64 (the
    wrappers take float32 only; the plain versions run in float64 too)
    'pinv' also takes the float32 run's cutoff: a float64 run then solves
    the float32 run's problem free of its rounding. With grad, K4's plain
    version carries the kernel's derivative rule (plain_envelope_k4), not
    autograd through its iterations."""
    def resolve32(A, f, method):
        if method != "pinv":
            return core.resolve(A, f, method)
        rtol = 10.0 * max(A.shape[-2:]) * torch.finfo(torch.float32).eps
        return torch.linalg.pinv(A, rtol=rtol) @ f[..., None]

    hull_table = collision.hull_table
    patches = ((envs.base, "pullback_resolve_structured",
                cuda_resolve.pullback_resolve_structured_plain),
               (core, "fk_derivatives_batched", fk_derivatives),
               (franka, "fk_derivatives_batched", fk_derivatives),
               (contact, "fk_derivatives_batched", fk_derivatives),
               (collision, "gjk_hull_obstacles",
                plain_envelope_k4 if grad
                else cuda_gjk.gjk_hull_obstacles_plain))
    if float64:
        patches += ((envs.base, "resolve",
                     lambda A, f, m: resolve32(A, f, m).reshape(f.shape)),
                    (collision, "hull_table",
                     lambda model, dev: hull_table(model, dev).double()))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@spent()
def witness_q(scene: str, torque: bool, geometry: str = "capsule",
              warm_iters: int | None = None):
    """parity_q's CPU run of `scene` in float64 (plain_kernels), so it
    solves the same problem free of float32 rounding. Returns q and the
    solved flags."""
    env = envs.make(scene, device="cpu")
    env.torque_mode = torque
    env.collision_geometry = geometry
    env.hull_warm_iters = warm_iters or env.hull_warm_iters
    states = _as_dtype(perturbed_states(env, 128, 4, 0.1, 0.05),
                       torch.float64)
    params = tuple(_as_dtype(p, torch.float64) for p in env.gather_params())
    with plain_kernels(float64=True):
        final, aux = envs.make_batched_rollout(env, 5)(states, params)
    check(final.sim.q.dtype == torch.float64, f"witness of {scene}: dtype")
    return final.sim.q, aux["solved"].any(dim=1)


@spent()
def phase_new_scene_parity(runs=None) -> dict:
    """Every new scene (its own resolve method) and franka/01 in torque
    mode: 128 envs x 5 ticks from q ± 0.1, q̇ ± 0.05, GPU against CPU, on
    the envs that reached no goal in any run (the two devices' random
    resampling draws differ) and whose CPU run lies within STABLE of a
    float64 run of the same problem (witness_q): near its straight reset
    pose the two-joint arm's target metric is nearly singular, and two
    float32 pseudo-inverses there part by up to ~2e-3 in q after 5 ticks
    (the CPU's from float64 by 1.7e-3 on 3 of 128 envs, CPU run). A
    one-ulp move of the start misses these envs: it leaves the rounding
    inside the SVD alone. Every scene is run before any check. runs:
    (scene, torque mode) pairs or (scene, torque mode, geometry) triples,
    default NEW_SCENES and franka/01 in torque mode."""
    out, failed = {}, []
    for run in runs or NEW_SCENE_RUNS:
        scene, torque, geometry = (*run, "capsule")[:3]
        kw = dict(geometry=geometry, scene=scene, method=None, torque=torque,
                  solved=True)
        runs = [parity_q("cuda", 0.1, 0.05, **kw),
                cpu_run(parity_q, "cpu", 0.1, 0.05, **kw),
                cpu_run(witness_q, scene, torque, geometry)]
        (gpu, _), (cpu, _), (exact, _) = runs
        quiet = ~(runs[0][1] | runs[1][1] | runs[2][1])
        rounding = (cpu.double() - exact).abs().amax(dim=1)
        gap = (gpu - cpu).abs().amax(dim=1)
        keep = quiet & (rounding <= STABLE)
        rest = quiet & ~keep
        what = scene + (" (torque mode)" if torque else "") + (
            f" ({geometry})" if geometry != "capsule" else "")
        rec = dict(envs_compared=int(keep.sum()),
                   envs_with_goal_event=int((~quiet).sum()),
                   max_abs_q=float(gap[keep].max()),
                   max_abs_q_rounding_bound=float(gap[rest].max()) if
                   bool(rest.any()) else None,
                   max_cpu_vs_float64=float(rounding[quiet].max()),
                   max_gpu_vs_float64=float(
                       (gpu.double() - exact).abs().amax(dim=1)[keep].max()))
        log(f"parity {what}: 128 envs x 5 ticks from q ± 0.1, q̇ ± 0.05: "
            f"{json.dumps(rec)} (atol {PARITY_ATOL} on the envs compared)")
        if rec["envs_compared"] < 64:
            failed.append(f"parity {what}: too few envs compared")
        if rec["max_abs_q"] > PARITY_ATOL:
            failed.append(f"GPU/CPU parity of {what}")
        if rec["max_gpu_vs_float64"] > PARITY_ATOL:
            failed.append(f"GPU against float64 on {what}")
        out[what] = rec
    check(not failed, "; ".join(failed))
    return out


@spent()
def golden_rollout(name: str) -> dict:
    """A committed golden of tests/test_golden.py that runs through RmpCore,
    reproduced on the GPU with that file's loop: a v1 target on the EE,
    'pinv', 40 ticks of 10 substeps; franka01_torque routes each substep
    through τ = clip(ID(q, q̇, q̈_des), ±effort), q̈ = FD(τ) on the model
    with PyBullet's collision-shape inertia. K3 runs at B = 1."""
    data = np.load(os.path.join(ROOT, "tests", "golden",
                                f"{name}_trajectory.npz"))
    if name == "two_joint01":
        model, ee, q0 = robots.two_joint_robot(), "link_23", data["q0"]
    else:
        model, ee, q0 = (robots.franka_panda(), robots.PANDA_EE_FRAME,
                         robots.PANDA_Q_READY)
    torque = name == "franka01_torque"
    if torque:
        model = urdf.pybullet_collision_inertia(model)
    c = core.RmpCore(method="pinv")                      # the GPU by default
    c.add_rmp(v1.target_policy(
        goal=data["goal"], taskmap=tm.chain(tm.fk_frame(model, ee),
                                            tm.to_position()),
        alpha=0.1, beta=0.5, c=0.1, name="target"))
    dev = c.device
    q = torch.tensor(np.asarray(q0, np.float32), device=dev)
    qd = torch.zeros_like(q)
    effort = torch.tensor(model.effort_limit, device=dev)
    err = dict(qdd=0.0, q=0.0, tau=0.0)
    for t in range(data["qdd"].shape[0]):
        qdd = c.evaluate(q, qd)
        err["qdd"] = max(err["qdd"], float(np.abs(
            qdd.cpu().numpy() - data["qdd"][t]).max()))
        for s in range(10):
            if torque:
                tau = torch.clamp(dynamics.inverse_dynamics(model, q, qd, qdd),
                                  -effort, effort)
                err["tau"] = max(err["tau"], float(np.abs(
                    tau.cpu().numpy() - data["tau"][t, s]).max()))
                step_qdd = dynamics.forward_dynamics(model, q, qd, tau)
            else:
                step_qdd = qdd
            q, qd = dynamics.semi_implicit_euler_step(model, q, qd, step_qdd,
                                                      0.01)
        err["q"] = max(err["q"], float(np.abs(
            q.cpu().numpy() - data["q"][t + 1]).max()))
    return err


def phase_goldens() -> dict:
    out = {}
    for name, tol in GOLDEN_TOL.items():
        t0 = time.perf_counter()
        err = golden_rollout(name)
        seconds = time.perf_counter() - t0
        if name == "two_joint01":
            ok = max(err["qdd"], err["q"]) < tol["q_and_qdd"]
        elif name == "franka01":
            ok = err["qdd"] < tol["qdd"] and err["q"] < tol["q"]
        else:
            ok = err["tau"] < tol["tau"] and err["q"] < tol["q"]
        log(f"golden {name} on the GPU (RmpCore, K3 at B = 1): "
            f"{json.dumps(err)} (limits {json.dumps(tol)}), {seconds:.1f} s")
        check(ok, f"golden {name} on the GPU")
        out[name] = dict(err, seconds=seconds)
    return out


def phase_slice6(card: str, device) -> dict:
    """Phase 12: K1 at n = 6 and 2, K3 on the two new models, the UR5
    rollouts (K1 and K3 once per tick), GPU/CPU parity of the new scenes
    and of torque mode, and the three RmpCore goldens on the card."""
    k1_new, k1_err = phase_k1_new_n(device)
    k3_new, k3_err = phase_k3_new_models(device)
    paths = {scene: phase_main_path(card, "capsule", scene, PATH_TICKS)
             for scene in SCENES_UR5}
    return dict(k1=k1_new, k1_err=k1_err, k3=k3_new, k3_err=k3_err,
                paths=paths, parity=phase_new_scene_parity(),
                goldens=phase_goldens())


# ------------------------------------ phase 13: the seventh slice's paths ---

SCENES7_SOLVE = ("franka/moving_goal", "franka/moving_obstacles")
SCENES7_PINV = ("franka/03_self_avoidance", "franka/04_nullspace_control",
                "franka/pose_target")
SCENES7 = SCENES7_PINV + SCENES7_SOLVE
# the 'pinv' scenes resolve each tick by torch.linalg.pinv, a batched SVD:
# their rollouts are cut to PINV_TICKS ticks to keep the phase near a minute
PINV_TICKS = 30
# K1 on moving_goal's real tick: a dense 3-row attractor and three identity
# leaves, no scalar block (moving_obstacles has the flagship's layout)
K1_SLICE7_LAYOUTS = {
    "moving_goal": (9, (("dense", 3), ("identity", 0), ("identity", 0),
                        ("identity", 0)), "franka/moving_goal"),
}
IK_ATOL = 1e-4         # franka/04's IK start, GPU against CPU
MOVING = "franka/moving_obstacles"
# warm GJK iterations of moving_obstacles' hull parity: the scene's own, and
# 16, where the GJK has converged on most pairs
HULL_PARITY_ITERS = (data.WARM_ITERS, 16)
# moving_hull_parity's runs of parity_q
MOVING_HULL_KW = dict(geometry="hull", scene=MOVING, method=None, solved=True)
SIM_STEPS = 200        # tests/test_subsystems.py's wrapper loop
# its final q, GPU against CPU (tests/test_torch_ik_sim.py's limit against
# the JAX wrapper)
SIM_Q_TOL = 2e-3


@spent()
def pinv_cost(scene: str) -> dict:
    """What the 'pinv' resolve of one real tick of `scene` costs at BATCH
    envs: core.resolve(A, f, 'pinv') (torch.linalg.pinv, a batched SVD)
    from an idle stream and with the stream kept busy ahead, and the device
    kernels of one call (one trace); then PINV_TICKS ticks of the scene
    from its reset, each timed to a synchronize."""
    env = envs.make(scene)
    tags, blocks = real_tick_blocks(env, BATCH, 1)
    A, f = cuda_resolve.assemble_structured(tags, blocks)

    def call():
        return core.resolve(A, f, "pinv")
    rec = dict(ms=time_ms(call), device_ms=time_ms(call, lead=True))
    kernels = device_kernels(traced(call))
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name[:60]] = (by_name.get(e.name[:60], 0.0)
                                + e.time_range.elapsed_us())
    rec.update(device_launches_per_call=len(kernels),
               device_us=sum(by_name.values()),
               top=sorted(((round(v, 1), k) for k, v in by_name.items()),
                          reverse=True)[:5])
    # the scene's ticks one by one, each ended by a synchronize: a tick
    # far above the median points at work the trace's ticks did not show
    step, params = make_batched_control_step(env), env.gather_params()
    states = envs.make_batched_reset(env, BATCH)()
    ticks = []
    for _ in range(PINV_TICKS):
        t0 = time.perf_counter()
        states, _ = step(states, params)
        torch.cuda.synchronize()
        ticks.append((time.perf_counter() - t0) * 1e3)
    rec["synced_tick_ms"] = dict(median=float(np.median(ticks)),
                                 max=max(ticks),
                                 slowest_tick=int(np.argmax(ticks)),
                                 all=[round(t, 2) for t in ticks])
    log(f"'pinv' resolve of a {scene} tick at B={BATCH}: {json.dumps(rec)}")
    check(bool(torch.isfinite(call()).all()), f"{scene}: 'pinv' non-finite")
    return rec


@spent()
def phase_ik_start() -> dict:
    """franka/04's start pose: the scene's construction runs 200 DLS
    iterations on the card; the result against the CPU's, joint 5 clipped
    at its lower limit on both."""
    name = "franka/04_nullspace_control"
    t0 = time.perf_counter()
    gpu_env = envs.make(name)
    gpu = gpu_env.reset(1).sim.q[0]
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = envs.make(name, device="cpu").reset(1).sim.q[0]
    cpu_s = time.perf_counter() - t0
    err = float((gpu.cpu() - cpu).abs().max())
    low = float(gpu_env.model.q_lower[4])
    rec = dict(q_gpu=gpu.cpu().tolist(), max_abs_gpu_cpu=err,
               scene_build_s_gpu=gpu_s, scene_build_s_cpu=cpu_s)
    log(f"franka/04 IK start on the GPU against the CPU: {json.dumps(rec)} "
        f"(atol {IK_ATOL})")
    check(gpu.device.type == "cuda", "franka/04 IK: not on the card")
    check(err <= IK_ATOL, "franka/04 IK start: GPU against CPU")
    check(float(gpu[4]) == low and float(cpu[4]) == low,
          "franka/04 IK start: joint 5 off its lower limit")
    return rec


@spent(by="device")
def simulation_loop(device=None):
    """tests/test_subsystems.py's wrapper loop: Simulation and RmpCore
    ('cholesky') on `device` (default the card), a v1 EE target, a new q̈
    every 10 of SIM_STEPS steps. Returns (final q, EE distance to the goal
    at the start and at the end)."""
    sim = Simulation(delta_t=0.01, device=device).connect()
    robot = FrankaPanda()
    sim.populate_scene([robot, Goal(base_position=(0.6, 0.0, 0.4),
                                    radius=0.02)])
    model = robot.model
    c = core.RmpCore(method="cholesky", device=device)
    c.add_rmp(v1.target_policy(
        goal=[0.6, 0.0, 0.4],
        taskmap=tm.chain(tm.fk_frame(model, robots.PANDA_EE_FRAME),
                         tm.to_position()),
        alpha=0.1, beta=0.5, c=0.1, name="target"))
    ee = model.frame_index(robots.PANDA_EE_FRAME)
    goal = torch.tensor([0.6, 0.0, 0.4])

    def dist(q):
        return float(torch.linalg.vector_norm(kinematics.fk_frame(
            model, torch.as_tensor(q), ee)[:3, 3] - goal))
    d0 = dist(sim.q)
    qdd = None
    for i in range(SIM_STEPS):
        if i % 10 == 0:
            q, qd, ctx = sim.state()
            qdd = c.evaluate(q, qd, context=ctx)
        sim.step(qdd)
    check(sim.device == c.device, "Simulation and RmpCore on two devices")
    return sim.q, d0, dist(sim.q)


def phase_simulation() -> dict:
    t0 = time.perf_counter()
    q_gpu, d0, d_gpu = simulation_loop()
    seconds = time.perf_counter() - t0
    q_cpu, _, d_cpu = simulation_loop("cpu")
    rec = dict(ee_goal_start=d0, ee_goal_end_gpu=d_gpu, ee_goal_end_cpu=d_cpu,
               max_abs_q_gpu_cpu=float(np.abs(q_gpu - q_cpu).max()),
               seconds_gpu=seconds)
    log(f"Simulation wrapper on the GPU, {SIM_STEPS} steps: "
        f"{json.dumps(rec)} (atol {SIM_Q_TOL} on q)")
    check(d_gpu < d0, "Simulation wrapper: the EE did not near its goal")
    check(rec["max_abs_q_gpu_cpu"] <= SIM_Q_TOL,
          "Simulation wrapper: GPU against CPU")
    return rec


def phase_k4_scene(scene: str = MOVING, want_iters: int = data.WARM_ITERS,
                   cap_fault: bool = False) -> dict:
    """K4 on `scene`'s own warm operands (k4_main_path_operands: the hull
    tier at BATCH envs 20 ticks in, the carry of the previous tick; under
    moving obstacles the carry of their previous positions) at the scene's
    warm iteration count, against its plain version with phase 6's limits
    (k4_compare, k4_evidence); timed beside the bound of what its pairs
    need (k4_bound_needed)."""
    ops, iters = k4_main_path_operands(scene, method=None)
    check(iters == want_iters, f"K4 on {scene}: {iters} iterations")
    return k4_operands_check(ops, iters, f"K4 {scene} operands, {iters} "
                             f"iterations", cap_fault)


def k4_operands_check(ops: dict, iters: int, what: str, cap_fault: bool,
                      witness_quantile: bool = True) -> dict:
    """K4 on `ops` at `iters` iterations against its plain version with
    phase 6's limits (k4_compare, its witness quantiles or, with
    witness_quantile False, as k4_in_loop holds random cylinders, each
    pair's ball in k4_evidence), timed beside the bound of what its pairs
    need (k4_bound_needed)."""
    def call():
        return cuda_gjk.gjk_hull_obstacles(**ops, iters=iters)

    def plain():
        return cuda_gjk.gjk_hull_obstacles_plain(**ops, iters=iters)
    got, want = call(), plain()
    rec = k4_compare(got, want, what, witness_quantile)
    rec["evidence"] = k4_evidence(ops, got, want, what, cap_fault)
    needed, live = k4_needed_iterations(ops, iters)
    rec.update(iters=iters, ms=time_ms(call),
               device_ms=time_ms(call, lead=True),
               plain_ms=time_ms(plain, reps=5), live_share=live,
               mean_needed_iterations=float(needed.double().mean()))
    rec["bound_ms"], rec["bound_by"] = k4_bound_needed(ops, needed)
    log(f"{what}: kernel {rec['ms']:.4f} ms (device alone "
        f"{rec['device_ms']:.4f} ms), plain {rec['plain_ms']:.4f} ms, bound "
        f"{rec['bound_ms']:.6f} ms ({rec['bound_by']}); share of pairs still "
        f"changing after iteration i {json.dumps(live)}")
    return rec


@contextlib.contextmanager
def gjk_as(fn):
    """collision.gjk_hull_obstacles replaced by fn while the block runs."""
    saved = collision.gjk_hull_obstacles
    collision.gjk_hull_obstacles = fn
    try:
        yield
    finally:
        collision.gjk_hull_obstacles = saved


def k4_in_loop(calls: list, env_gaps: list, failed: list,
               evidence_every: int = 1, random_cylinders: bool = False):
    """A stand-in for collision.gjk_hull_obstacles in a run on the card:
    each call launches K4 and its plain version on the same operands, holds
    the two to phase 6's limits (k4_compare on every call, k4_evidence on
    the first and every evidence_every-th; with random_cylinders the
    witnesses' p99 is held by k4_evidence's balls on the calls that miss
    it, and k4_evidence takes its cap_fault form; a miss goes to
    `failed`),
    appends their record to `calls` and, per env, the largest |Δdist| and
    witness gap over the env's pairs to `env_gaps`, and passes K4's answer
    on."""
    def call(verts, R, t, p0, p1, an, radius, is_cyl, d0, iters=10):
        ops = dict(verts=verts, R=R, t=t, p0=p0, p1=p1, an=an,
                   radius=radius, is_cyl=is_cyl, d0=d0)
        got = cuda_gjk.gjk_hull_obstacles(**ops, iters=iters)
        want = cuda_gjk.gjk_hull_obstacles_plain(**ops, iters=iters)
        what = f"K4 in the loop, call {len(calls) + 1}, {iters} iterations"
        rec = dict(iters=iters)
        try:
            rec.update(k4_compare(got, want, what,
                                  witness_quantile=not random_cylinders))
            if (len(calls) % evidence_every == 0
                    or not rec["witness_quantile_met"]):
                rec["evidence"] = k4_evidence(ops, got, want, what,
                                              cap_fault=random_cylinders)
        except AssertionError as e:
            failed.append(str(e))
        calls.append(rec)
        env_gaps.append((
            (got[2] - want[2]).abs().amax(dim=(0, 1)).cpu(),
            torch.maximum((got[0] - want[0]).abs().amax(dim=(0, 1, 2)),
                          (got[1] - want[1]).abs().amax(dim=(0, 1, 2))
                          ).cpu()))
        return got
    return call


@spent()
def moving_hull_parity(warm_iters: int) -> tuple[dict, list]:
    """franka/moving_obstacles in the hull tier, 128 envs (broad phase, warm
    carry following the moving obstacles) x 5 ticks from q ± 0.1,
    q̇ ± 0.05 at `warm_iters` warm GJK iterations. Runs: the card with K4
    checked in the loop (k4_in_loop: every call, the reset's cold one
    included, against its plain version on the card's own operands), the
    card with K4's plain version in its place, the CPU, the CPU from a start
    moved by one ulp, float64 (witness_q), and the CPU at one more warm
    iteration (printed only). Screened envs: no goal event in any run, and
    a CPU run that each of three rounding-level changes leaves within
    STABLE: the one-ulp move, float64, and the card's arithmetic outside K4
    (the run with the plain version in K4's place). The truncated GJK turns
    rounding into different answers on some envs, and the three changes
    find different ones. Held:
      - every K4 call within phase 6's limits;
      - the card's run within PARITY_ATOL of the CPU and of float64 on the
        screened envs: K4 is the only change there, so a gap is K4's;
      - on every env where K4 and its plain version parted at some call
        (a pair's |Δdist| above K4_AGREE or witnesses above
        K4_WITNESS_P99), the witness gap within K4_WITNESS_MAX.
    Returns the record and the failures."""
    kw = MOVING_HULL_KW
    calls, env_gaps, failed = [], [], []
    with gjk_as(k4_in_loop(calls, env_gaps, failed)):
        gpu, s0 = parity_q("cuda", 0.1, 0.05, warm_iters=warm_iters, **kw)
    with gjk_as(cuda_gjk.gjk_hull_obstacles_plain):
        gpu_plain, s1 = parity_q("cuda", 0.1, 0.05, warm_iters=warm_iters,
                                 **kw)
    cpu, s2 = cpu_run(parity_q, "cpu", 0.1, 0.05, warm_iters=warm_iters,
                      **kw)
    ulp, s3 = cpu_run(parity_q, "cpu", 0.1, 0.05, ulp=True,
                      warm_iters=warm_iters, **kw)
    more, s4 = cpu_run(parity_q, "cpu", 0.1, 0.05,
                       warm_iters=warm_iters + 1, **kw)
    exact, s5 = cpu_run(witness_q, MOVING, False, "hull", warm_iters)

    def gap(a, b):
        return (a.double() - b.double()).abs().amax(dim=1)

    def top(v, where):
        return float(v[where].max()) if bool(where.any()) else None
    quiet = ~(s0 | s1 | s2 | s3 | s4 | s5)
    moves = dict(ulp=gap(ulp, cpu), float64=gap(cpu, exact),
                 card_outside_k4=gap(gpu_plain, cpu))
    keep = quiet.clone()
    for m in moves.values():
        keep &= m <= STABLE
    env_dist = torch.stack([d for d, _ in env_gaps]).amax(dim=0)
    env_wit = torch.stack([w for _, w in env_gaps]).amax(dim=0)
    parted = (env_dist > K4_AGREE) | (env_wit > K4_WITNESS_P99)
    q_gap, more_move = gap(gpu, cpu), gap(more, cpu)
    rec = dict(
        warm_iters=warm_iters, k4_calls=len(calls),
        envs_with_goal_event=int((~quiet).sum()),
        envs_kept_by_each_screen={k: int((quiet & (m <= STABLE)).sum())
                                  for k, m in moves.items()},
        envs_compared=int(keep.sum()),
        max_abs_q=top(q_gap, keep),
        max_gpu_vs_float64=top(gap(gpu, exact), keep),
        max_abs_q_screened_out=top(q_gap, quiet & ~keep),
        median_abs_q_all=float(q_gap[quiet].median()),
        max_move={k: float(m[quiet].max()) for k, m in moves.items()},
        k4_dist_gap_per_call=[c.get("dist_max") for c in calls],
        k4_witness_gap_per_call=[c.get("witness_max") for c in calls],
        envs_k4_parted=int(parted.sum()),
        max_k4_witness_gap_parted=top(env_wit, parted),
        max_abs_q_k4_parted=top(q_gap, parted),
        one_more_iteration_move=dict(median=float(more_move[quiet].median()),
                                     max=float(more_move[quiet].max())))
    # the envs that part most, with what each run and screen says of them
    worst = torch.argsort(torch.where(quiet, q_gap, torch.zeros_like(q_gap)),
                          descending=True)[:8].tolist()
    rec["worst_envs"] = [dict(
        env=e, abs_q=float(q_gap[e]), compared=bool(keep[e]),
        k4_dist_gap=float(env_dist[e]), k4_witness_gap=float(env_wit[e]),
        one_more_iteration_move=float(more_move[e]),
        **{f"{k}_move": float(m[e]) for k, m in moves.items()})
        for e in worst]
    rec["k4_calls_record"] = calls
    what = f"hull parity of {MOVING} at {warm_iters} warm iterations"
    if rec["envs_compared"] < 64:
        failed.append(f"{what}: too few envs compared")
    for key in ("max_abs_q", "max_gpu_vs_float64"):
        if rec[key] is not None and rec[key] > PARITY_ATOL:
            failed.append(f"{what}: {key} {rec[key]:.3e} > {PARITY_ATOL}")
    if (rec["max_k4_witness_gap_parted"] or 0.0) > K4_WITNESS_MAX:
        failed.append(f"{what}: K4's witnesses part from the plain "
                      f"version's by more than {K4_WITNESS_MAX}")
    return rec, failed


def phase_moving_hull_parity() -> dict:
    """moving_hull_parity at each of HULL_PARITY_ITERS; every run is made
    before any check."""
    out, failed = {}, []
    for iters in HULL_PARITY_ITERS:
        rec, miss = moving_hull_parity(iters)
        out[f"warm_iters_{iters}"] = rec
        failed += miss
        shown = {k: v for k, v in rec.items() if k != "k4_calls_record"}
        log(f"parity {MOVING} (hull, 128 envs, warm carry, {iters} warm GJK "
            f"iterations) x 5 ticks from q ± 0.1, q̇ ± 0.05: "
            f"{json.dumps(shown)} (atol {PARITY_ATOL})")
    check(not failed, "; ".join(failed))
    return out


def phase_slice7(card: str, device) -> dict:
    """Phase 13: K1 on moving_goal's layout, K4 on moving_obstacles' warm
    operands, the five new scenes' rollouts
    at BATCH envs (moving_obstacles in both tiers), the 'pinv' resolve's
    cost, GPU/CPU parity of the five scenes and of moving_obstacles in the
    hull tier, franka/04's IK start and the Simulation wrapper on the
    card."""
    k1_new, k1_err = phase_k1_new_n(device, K1_SLICE7_LAYOUTS)
    k4_moving = phase_k4_scene()
    paths = {}
    for scene in SCENES7_SOLVE:
        paths[scene] = phase_main_path(card, "capsule", scene, PATH_TICKS,
                                       method=None)
    paths[f"{MOVING} (hull)"] = phase_main_path(card, "hull", MOVING,
                                                PATH_TICKS, method=None)
    for scene in SCENES7_PINV:
        paths[scene] = phase_main_path(card, "capsule", scene,
                                       ticks=PINV_TICKS, method=None)
    pinv = {scene: pinv_cost(scene) for scene in SCENES7_PINV}
    return dict(k1=k1_new, k1_err=k1_err, k4=k4_moving, paths=paths,
                pinv=pinv,
                parity=phase_new_scene_parity([(s, False) for s in SCENES7]),
                hull_parity=phase_moving_hull_parity(),
                ik_start=phase_ik_start(), simulation=phase_simulation())


# ------------------------------------ phase 14: the eighth slice's paths ---

RANDOMIZED = "franka/randomized_cluttered"
RANDOMIZED_TICKS = 300
RANDOMIZED_SEED = 0          # the rollouts' reset, fixed before any run
# the JAX package's statistics of this scene at 4096 envs x 300 ticks
REPORTS = {"capsule": "reports/eval_randomized.json",
           "hull": "reports/eval_randomized_hull.json"}
STAT_KEYS = ("first_goal_success_rate", "success_rate",
             "final_penetration_rate")
# K1 on a real tick 60 ticks into a rollout, where pushes and detours give
# the envs their own gains; (tag, rows): the attractor, three identity
# leaves and the grouped obstacle policy over 10 links x 8 obstacle slots
K1_RANDOMIZED_TICKS = 60
K1_RANDOMIZED_LAYOUT = (("dense", 3), ("identity", 0), ("identity", 0),
                        ("identity", 0), ("scalar", 80))
PARITY_B = 128
PARITY_TICKS = 8      # cut from 60 to 30 in the eleventh slice, to 20 in
                      # the thirteenth, to 12 in the fourteenth, to 8 in the
                      # fifteenth, for time
PARITY_SEED = 1
# least share of the (env, tick) pairs before each env's first event that
# the rounding screens keep: a floor on what the parity covers, not a
# tolerance (PERF.md gives the shares measured)
KEPT_SHARE = 0.1
K4_EVIDENCE_EVERY = 10       # k4_evidence on every 10th K4 call of a run


def stat_limit(p: float) -> float:
    """3 sigma of the difference of two independent BATCH-env samples of a
    rate p."""
    return 3.0 * float(np.sqrt(2.0 * p * (1.0 - p) / BATCH))


def _take(x, B: int):
    """A (nested) state with every tensor's leading env axis cut to B."""
    return _tree_map(lambda t: t[:B] if isinstance(t, torch.Tensor) else t,
                     x)


def _to_device(x, device):
    """A (nested) state on `device`; its generator a new one seeded 0 (the
    runs compared never use its draws: they stop at the first event)."""
    def move(t):
        if isinstance(t, torch.Tensor):
            return t.to(device)
        if isinstance(t, torch.Generator):
            return envs.base.generator(device, 0)
        return t
    return _tree_map(move, x)


def sync_free_tick(env, states, params, what: str) -> list:
    """One tick with torch.cuda.set_sync_debug_mode('warn'): the
    synchronizing calls it made (copies from the host included), each as
    'file:line message' of the line that made it, which must be none, so
    that the tick never waits on the device."""
    step = make_batched_control_step(env)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(states, params)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno} "
             f"{str(w.message)[:120]}" for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    log(f"{what}: synchronizing calls in one tick: {len(syncs)} {syncs[:3]}")
    return syncs


def phase_k1_randomized(device, scene: str = RANDOMIZED,
                        key: str = "randomized") -> tuple[dict, float]:
    """K1 on the real tick of `scene` (the randomized scene, or one on its
    substrate: pre_tick, the state-aware bind, the blocks)
    K1_RANDOMIZED_TICKS ticks into a BATCH-env rollout, against its plain
    version at B = 4096 and the first 1, 7 and 4093 envs; one device kernel
    per call; timed beside its bound. The record goes under `key`."""
    env = envs.make(scene)
    params = env.gather_params()
    states = envs.make_batched_reset(env, BATCH, RANDOMIZED_SEED + 2)()
    states, _ = envs.make_batched_rollout(env, K1_RANDOMIZED_TICKS,
                                          with_aux=False)(states, params)
    states = env.pre_tick(states)
    sc = states.scratch
    escaping = sc["man_ticks"] > 0
    pushing = ~escaping & sc["push_on"]
    log(f"K1 {scene} real tick, {K1_RANDOMIZED_TICKS} ticks in: "
        f"{int(escaping.sum())} envs in a detour, {int(pushing.sum())} "
        f"pushing, of {BATCH}")
    err = 0.0
    for B in RAGGED + (BATCH,):
        q, qd, prm, ctxs, fk = _policy_inputs(env, _take(states, B), params)
        tags, blocks = policy_row_blocks_structured(env.policies, q, qd, prm,
                                                    ctxs, fk=fk)
        rows = tuple((t, b[0].shape[1] if t != "identity" else 0)
                     for t, b in zip(tags, blocks))
        check(rows == K1_RANDOMIZED_LAYOUT, f"K1 {scene} layout {rows}")
        err = max(err, k1_compare(tags, blocks,
                                  f"{scene} real tick, B={B}",
                                  nonfinite_ok=True))

    # timed on the last blocks, BATCH envs
    def call():
        return cuda_resolve.pullback_resolve_structured(tags, blocks)
    per_call = device_launches(call, "pullback_resolve_kernel",
                               f"K1 {scene}")
    check(per_call == 1, f"K1 {scene}: not one launch per wrapper call")
    rec = dict(n=9, scene=scene,
               layout=[list(r) for r in K1_RANDOMIZED_LAYOUT],
               envs_in_a_detour=int(escaping.sum()),
               envs_pushing=int(pushing.sum()),
               device_launches_per_call=per_call, ms=time_ms(call),
               device_ms=time_ms(call, lead=True),
               plain_ms=time_ms(lambda: cuda_resolve.
                                pullback_resolve_structured_plain(tags,
                                                                  blocks)),
               library_ms=time_ms(lambda: k1_library(tags, blocks)))
    rec["bound_ms"], rec["bound_by"] = k1_bound(tags, blocks)
    log(f"K1 {scene} (n=9, dense 3 + 3 identities + scalar 80) times at "
        f"B={BATCH}: wrapper {rec['ms']:.4f} ms (device alone "
        f"{rec['device_ms']:.4f} ms), plain {rec['plain_ms']:.4f} ms, "
        f"einsum+linalg.solve {rec['library_ms']:.4f} ms, bound "
        f"{rec['bound_ms']:.6f} ms ({rec['bound_by']})")
    return {key: rec}, err


@spent()
def randomized_path(card: str, geometry: str, failed: list,
                    scene: str = RANDOMIZED,
                    k3_per_tick: int = 1 + franka.IK_STEPS,
                    reports: dict = REPORTS):
    """`scene` (a randomized scene) at BATCH envs x RANDOMIZED_TICKS ticks
    in `geometry` from the reset of RANDOMIZED_SEED, timed, with every
    launch counter zeroed just before the rollout and read after: K1 once
    per tick, K3 k3_per_tick times (RANDOMIZED: 1 + IK_STEPS, the tick's
    FK and the detour IK's), K4 once per hull tick (in RANDOMIZED the
    reset's cold seeding query comes before), every other counter 0.
    Before it, on a reset of another seed, one tick with the sync debug
    mode on (sync_free_tick). After it, the task statistics
    (evaluate.task_statistics) against the JAX package's report
    (reports[geometry]) within stat_limit, nan_rate 0 (a miss goes to
    `failed`), and a 10-tick trace."""
    what = f"{scene} ({geometry})"
    env = envs.make(scene)
    env.collision_geometry = geometry
    params = env.gather_params()
    warm = envs.make_batched_reset(env, BATCH, RANDOMIZED_SEED + 1)()
    warm, _ = envs.make_batched_rollout(env, WARMUP_TICKS, with_aux=False)(
        warm, params)
    syncs = sync_free_tick(env, warm, params, what)
    if syncs:
        failed.append(f"{what}: the tick synchronizes with the device")
    initial = envs.make_batched_reset(env, BATCH, RANDOMIZED_SEED)()
    rollout = envs.make_batched_rollout(env, RANDOMIZED_TICKS)
    torch.cuda.synchronize()
    for fn in COUNTERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    final, aux = rollout(initial, params)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    steps_per_s = BATCH * RANDOMIZED_TICKS / seconds
    log(f"{what}: {BATCH} envs x {RANDOMIZED_TICKS} ticks in {seconds:.3f} s "
        f"= {steps_per_s:.1f} control steps/s [{card}]")
    log(f"{what} launches: {launches}")
    per_tick = dict(pullback_resolve_structured=1,
                    fk_derivatives_batched=k3_per_tick,
                    gjk_hull_obstacles=int(geometry == "hull"))
    for name, count in launches.items():
        want = RANDOMIZED_TICKS * per_tick.get(name, 0)
        check(count == want, f"{what}: {name} launched {count} times in "
              f"{RANDOMIZED_TICKS} ticks, want {want}")
    check(tuple(final.sim.q.shape) == (BATCH, env.model.n_q),
          f"{what}: q shape")
    stats = task_statistics(env, initial, final, aux)
    with open(os.path.join(ROOT, reports[geometry])) as f:
        report = json.load(f)
    against = {}
    for key in STAT_KEYS:
        p = report[key]
        against[key] = dict(port=stats[key], report=p,
                            diff=stats[key] - p, limit=stat_limit(p))
        if abs(stats[key] - p) > stat_limit(p):
            failed.append(f"{what}: {key} {stats[key]:.5f} against the "
                          f"report's {p:.5f} (limit {stat_limit(p):.5f})")
    if stats["nan_rate"] != 0.0:
        failed.append(f"{what}: nan_rate {stats['nan_rate']}")
    log(f"{what} statistics: {json.dumps(stats)}")
    log(f"{what} against {reports[geometry]}: {json.dumps(against)}")
    trace = profile_ticks(env, final, params, seconds * 1e3 /
                          RANDOMIZED_TICKS)
    log(f"{what} trace: {json.dumps(trace)}")
    return launches, dict(scene=scene, geometry=geometry, envs=BATCH,
                          ticks=RANDOMIZED_TICKS, seed=RANDOMIZED_SEED,
                          seconds=seconds, control_steps_per_s=steps_per_s,
                          sync_calls_per_tick=len(syncs), statistics=stats,
                          against_report=against, trace=trace)


# the scratch entries of each randomized scene's discrete bookkeeping, beside
# EnvState.no_progress (the dual arm's per arm, (B, 2)); a scene without a
# scratch has no_progress alone
DISCRETE = {RANDOMIZED: ("push_on", "man_ticks", "man_count")}


@contextlib.contextmanager
def resolve_recorded(flags: list):
    """While the block runs, the tick's resolve (K1's wrapper or whatever
    stands in its place) appends the (B,) flags of its non-finite q̈ rows
    to `flags`: where the velocity cap's metric meets its singularity,
    |q̇| = max_velocity - 2 region, q̈ is not finite and the max_qdd guard
    zeros it."""
    resolve = envs.base.pullback_resolve_structured

    def recorded(tags, blocks, ridge=0.0, block_dtype=None):
        out = resolve(tags, blocks, ridge=ridge, block_dtype=block_dtype)
        flags.append(~torch.isfinite(out).all(dim=1))
        return out
    envs.base.pullback_resolve_structured = recorded
    try:
        yield
    finally:
        envs.base.pullback_resolve_structured = resolve


@spent(by="device")
def randomized_run(device, start, geometry: str, plain: bool = False,
                   float64: bool = False, k4=None, scene: str = RANDOMIZED,
                   ticks: int = PARITY_TICKS) -> dict:
    """Per-tick records (T, B, ...) of `ticks` ticks of `scene` from the
    CPU state `start`, moved to `device`: q (float64), the largest |q̈|
    (after the max_qdd guard), the discrete bookkeeping (no_progress and
    DISCRETE[scene]), `event`, a resample or a new maneuver (a count rises)
    at that tick (a scene without resampling has none),
    `singular`, a non-finite q̈ of K1's resolve (resolve_recorded), and
    `to_singular`, the least | |q̇_j| - (max_velocity - 2 region) | over
    the joints after the tick, how near the velocity cap's metric is to its
    singularity at the next tick (inf without a velocity cap). plain /
    float64 run plain_kernels; k4 stands in for K4 (gjk_as)."""
    env = envs.make(scene, device=device)
    env.collision_geometry = geometry
    state, params = _to_device(start, device), env.gather_params()
    if float64:
        state = _as_dtype(state, torch.float64)
        params = tuple(_as_dtype(p, torch.float64) for p in params)
    step = make_batched_control_step(env)
    cap = next((p.params for p in env.policies
                if p.name == "joint_velocity_cap"), None)
    singular_speed = (float("inf") if cap is None else cap["max_velocity"]
                      - 2.0 * cap["velocity_damping_region"])
    out = dict(q=[], qdd=[], event=[], discrete=[], singular=[],
               to_singular=[])
    with (plain_kernels(float64) if plain or float64 else
          gjk_as(k4) if k4 is not None else contextlib.nullcontext()), \
            resolve_recorded(out["singular"]):
        if _wants_gjk_warm(env, state):
            state = _seed_gjk_warm(env, state)
        for _ in range(ticks):
            sc = state.scratch or {}
            count = sc.get("man_count")
            state, aux = step(state, params)
            sc = state.scratch or {}
            B = state.sim.q.shape[0]
            out["q"].append(state.sim.q.double().cpu())
            out["to_singular"].append((state.sim.qd.abs() - singular_speed)
                                      .abs().amin(dim=1).double().cpu())
            out["qdd"].append(aux["qdd"].abs().amax(dim=1).double().cpu())
            event = aux.get("resample", torch.zeros_like(aux["solved"]))
            if count is not None:
                event = event | (sc["man_count"] > count).reshape(
                    B, -1).any(dim=1)
            out["event"].append(event.cpu())
            out["discrete"].append(torch.cat(
                [state.no_progress[:, None]] + [
                    sc[k].int().reshape(B, -1)
                    for k in DISCRETE.get(scene, ())], dim=1).cpu())
    # a scene that resolves by 'pinv' or 'cholesky' never calls K1's
    # wrapper: no resolve is recorded, none counts as singular
    out["singular"] = ([f.cpu() for f in out["singular"]] or
                       [torch.zeros_like(e) for e in out["event"]])
    return {k: torch.stack(v) for k, v in out.items()}


@spent()
def randomized_cpu_runs(geometry: str, scene: str, B: int, ticks: int,
                        spread: tuple | None, start_of: str | None):
    """randomized_parity's CPU side: the start (B envs of one CPU reset of
    PARITY_SEED, moved by spread = (dq, dqd) where given, or the state the
    function named start_of returns) and the CPU run from it, from it moved
    by one ulp, and in float64."""
    env = envs.make(scene, device="cpu")
    env.collision_geometry = geometry
    if start_of is not None:
        start = globals()[start_of]()
    elif spread is None:
        start = env.reset(B, PARITY_SEED)
    else:
        start = perturbed_states(env, B, PARITY_SEED, *spread)
    up = torch.tensor(float("inf"))
    moved = dataclasses.replace(start, sim=dataclasses.replace(
        start.sim, q=torch.nextafter(start.sim.q, up),
        qd=torch.nextafter(start.sim.qd, up)))
    run = functools.partial(randomized_run, geometry=geometry, scene=scene,
                            ticks=ticks)
    return start, dict(cpu=run("cpu", start), ulp=run("cpu", moved),
                       float64=run("cpu", start, float64=True))


def randomized_parity(geometry: str, failed: list, scene: str = RANDOMIZED,
                      B: int = PARITY_B, ticks: int = PARITY_TICKS,
                      spread: tuple | None = None,
                      start_of: str | None = None) -> dict:
    """GPU/CPU parity of `scene` (RANDOMIZED, or another scene with its
    DISCRETE entry, or none): B envs of one CPU reset (a scene whose reset
    is deterministic moved by spread = (dq, dqd), perturbed_states), or
    the CPU EnvState of B envs that the function named start_of returns,
    moved to the card, `ticks` ticks on each (randomized_cpu_runs makes the
    CPU side). The scene is chaotic in
    float32 (a one-ulp move of the start parts q by up to ~1.8 rad in 60
    ticks on some envs of a CPU run), and its bookkeeping has thresholds
    (the progress window's 1 cm, the push's 8 cm) that rounding can tip,
    and the velocity cap's metric has a singularity at |q̇| = 0.5 rad/s,
    which its dynamics approach, where one run's q̈ turns non-finite (the
    max_qdd guard zeros it) and another's stays finite. So each env is
    compared up to the tick before its first event in any run (a
    resample, or a new detour: the runs' random draws differ from there),
    before its first non-finite q̈ in any run, and before the card's
    discrete bookkeeping (DISCRETE) first parts from the CPU's, and each
    (env, tick) there while the rounding
    screens hold: the CPU run from a start moved by one ulp, the float64
    run and the card's run with the plain versions in the kernels' places
    (its rounding outside the kernels) have each stayed within STABLE of
    the CPU run. Held on those pairs: the card within PARITY_ATOL of the
    CPU and of float64, so that a gap there is the kernels'; at least
    KEPT_SHARE of the (env, tick) pairs before the events kept. In the
    hull tier every K4 call of the card's run is held against its plain
    version on the same operands (k4_in_loop, random_cylinders;
    k4_evidence on the first and every K4_EVIDENCE_EVERY-th call). A miss
    goes to `failed`."""
    start, cpu_runs = cpu_run(randomized_cpu_runs, geometry, scene, B, ticks,
                              spread, start_of)
    calls, env_gaps, k4_failed = [], [], []
    k4 = (k4_in_loop(calls, env_gaps, k4_failed, K4_EVIDENCE_EVERY,
                     random_cylinders=True) if geometry == "hull" else None)
    run = functools.partial(randomized_run, geometry=geometry, scene=scene,
                            ticks=ticks)
    runs = dict(gpu=run("cuda", start, k4=k4),
                card_plain=run("cuda", start, plain=True), **cpu_runs)
    T = ticks
    ticks = torch.arange(T)[:, None]

    def first(flags):                          # (T, B) -> (B,)
        return torch.where(flags.any(dim=0), flags.int().argmax(dim=0),
                           torch.tensor(T))
    first_event = first(torch.stack([r["event"] for r in runs.values()])
                        .any(dim=0))
    first_singular = first(torch.stack([r["singular"] for r in
                                        runs.values()]).any(dim=0))
    parted = (runs["gpu"]["discrete"] != runs["cpu"]["discrete"]).any(-1)
    first_part = first(parted)
    events = ticks < first_event[None]
    window = (events & (ticks < first_singular[None])
              & (ticks < first_part[None]))

    def gap(a, b):
        return (runs[a]["q"] - runs[b]["q"]).abs().amax(dim=-1)   # (T, B)
    screens = ("ulp", "float64", "card_plain")
    moves = {k: torch.cummax(gap(k, "cpu"), dim=0).values for k in screens}
    keep = window.clone()
    for m in moves.values():
        keep &= m <= STABLE
    g_cpu, g_f64 = gap("gpu", "cpu"), gap("gpu", "float64")

    def top(v, where):
        return float(v[where].max()) if bool(where.any()) else None
    split = (first_part < first_event)
    before = torch.clamp(first_part - 1, min=0)
    rec = dict(
        envs=B, ticks=T,
        envs_with_an_event=int((first_event < T).sum()),
        event_pairs=int(events.sum()), window_pairs=int(window.sum()),
        kept_pairs=int(keep.sum()),
        envs_with_kept_ticks=int(keep.any(dim=0).sum()),
        kept_by_each_screen={k: int((window & (m <= STABLE)).sum())
                             for k, m in moves.items()},
        envs_discrete_parted=int(split.sum()),
        envs_singular_in_window=int((first_singular < first_event).sum()),
        envs_singular_by_run={k: int(r["singular"].any(dim=0).sum())
                              for k, r in runs.items()},
        # each run's envs whose q̈ turned non-finite: the tick, and how near
        # a joint's |q̇| stood to the singular speed just before it
        singular=[dict(run=k, env=e, tick=int(t), qd_to_singular=float(
            r["to_singular"][t - 1, e]) if t > 0 else None)
            for k, r in runs.items()
            for e in r["singular"].any(dim=0).nonzero()[:, 0].tolist()
            for t in [first(r["singular"])[e]]],
        max_abs_q_before_discrete_part=top(
            g_cpu.gather(0, before[None])[0], split & (first_part > 0)),
        max_abs_q=top(g_cpu, keep), max_gpu_vs_float64=top(g_f64, keep),
        max_abs_q_window=top(g_cpu, window),
        median_abs_q_window=float(g_cpu[window].median()))
    # the kept pairs where the card parts most, with the tick its gap
    # first passed STABLE and the largest |q̈| of each run there
    onset = first(g_cpu > STABLE)
    worst = torch.argsort(torch.where(keep, g_cpu, torch.zeros_like(g_cpu))
                          .amax(dim=0), descending=True)[:5].tolist()
    rec["worst_envs"] = []
    for e in worst:
        o = int(min(int(onset[e]), T - 1))
        rec["worst_envs"].append(dict(
            env=e, abs_q=top(g_cpu[:, e], keep[:, e]),
            kept_ticks=int(keep[:, e].sum()), window_end=int(
                min(first_event[e], first_part[e], first_singular[e])),
            onset_tick=o,
            qdd_gpu=float(runs["gpu"]["qdd"][o, e]),
            qdd_cpu=float(runs["cpu"]["qdd"][o, e]),
            **{f"{k}_move": float(m[o, e]) for k, m in moves.items()}))
    if calls:                                  # the hull tier's K4 calls
        failed.extend(k4_failed)
        env_dist = torch.stack([d for d, _ in env_gaps]).amax(dim=0)
        env_wit = torch.stack([w for _, w in env_gaps]).amax(dim=0)
        k4_parted = (env_dist > K4_AGREE) | (env_wit > K4_WITNESS_P99)
        rec.update(k4_calls=len(calls),
                   k4_calls_with_evidence=sum("evidence" in c
                                              for c in calls),
                   k4_dist_gap_max=max(c.get("dist_max", 0.0)
                                       for c in calls),
                   k4_witness_gap_max=max(c.get("witness_max", 0.0)
                                          for c in calls),
                   k4_witness_p99_max=max(c.get("witness_p99", 0.0)
                                          for c in calls),
                   envs_k4_parted=int(k4_parted.sum()),
                   envs_k4_parted_with_kept_ticks=int(
                       (k4_parted & keep.any(dim=0)).sum()))
    what = f"parity {scene} ({geometry}, {B} envs)"
    log(f"{what} x {T} ticks: {json.dumps(rec)} (atol {PARITY_ATOL} on the "
        f"kept (env, tick) pairs)")
    if rec["kept_pairs"] < KEPT_SHARE * rec["event_pairs"]:
        failed.append(f"{what}: too few (env, tick) pairs kept")
    for key in ("max_abs_q", "max_gpu_vs_float64"):
        if rec[key] is None or rec[key] > PARITY_ATOL:
            failed.append(f"{what}: {key} {rec[key]} > {PARITY_ATOL}")
    return rec


def phase_slice8(card: str, device) -> dict:
    """Phase 14: K1 on the randomized scene's layout, K4 on its warm
    operands at 8 iterations, its 4096-env x 300-tick rollouts in both
    tiers with their statistics, and its GPU/CPU parity in both tiers.
    Every part runs before the statistics' and parities' checks."""
    k1_new, k1_err = phase_k1_randomized(device)
    k4_rand = phase_k4_scene(RANDOMIZED, 8, cap_fault=True)
    failed: list = []
    paths = {f"{RANDOMIZED} ({g})": randomized_path(card, g, failed)
             for g in ("capsule", "hull")}
    parity = {g: randomized_parity(g, failed) for g in ("capsule", "hull")}
    check(not failed, "; ".join(failed))
    return dict(k1=k1_new, k1_err=k1_err, k4=k4_rand, paths=paths,
                parity=parity)


# ------------------------------------- phase 15: the ninth slice's paths ---

DUAL_HANDOVER = "dual_panda/handover"
DUAL_RANDOMIZED = "dual_panda/randomized_clutter"
# the JAX package's statistics of the randomized dual scene at 4096 envs x
# 300 ticks
DUAL_REPORTS = {"capsule": "reports/eval_dual_randomized.json",
                "hull": "reports/eval_dual_randomized_hull.json"}
DISCRETE[DUAL_RANDOMIZED] = ("noprog", "man_ticks", "man_count")
# K1 at n = 18 on each dual scene's layout, (tag, rows): the two arms'
# attractors, three identity leaves, (randomized) each arm's grouped
# obstacle policy over its 10 links x 8 obstacle slots, and the inter-arm
# avoidance of the five distal left links (5 right links x 3 rows each)
_DUAL_HEAD = (("dense", 3), ("dense", 3), ("identity", 0), ("identity", 0),
              ("identity", 0))
_INTER_ARM = (("dense", 15),) * 5
K1_DUAL_LAYOUTS = {
    "dual handover": (_DUAL_HEAD + _INTER_ARM, DUAL_HANDOVER),
    "dual randomized": (_DUAL_HEAD + (("scalar", 80),) * 2 + _INTER_ARM,
                        DUAL_RANDOMIZED),
}
DUAL_K1_TICKS = 30           # the real ticks' blocks, this far in (60
                             # before the fifteenth slice)
DUAL_HANDOVER_TICKS = PATH_TICKS
DUAL_GOLDEN_ATOL = 1e-4      # tests/test_envs.py's limit on q (solved exact)
# the randomized dual parity, cut for time: a CPU tick of 64 envs takes
# ~0.2 s in the capsule tier and ~0.8 s in the hull tier on an 8-core host
# (envs, ticks); (32, 12) and (16, 6) before the fourteenth slice
DUAL_PARITY = {"capsule": (32, 8), "hull": (16, 4)}
# the handover in the hull tier, from reset states moved by q ± 0.1,
# q̇ ± 0.05: its arms meet at the centre, where the 10-iteration hull GJK
# turns rounding into different witnesses, so it is held per (env, tick)
# behind the one-ulp, float64 and card-with-plain-kernels screens
# (envs, ticks)
HANDOVER_HULL_PARITY = (32, 4)


def dual_tick_blocks(scene: str) -> dict:
    """{B: (tags, blocks)} of real ticks of `scene` on the card,
    DUAL_K1_TICKS ticks into a BATCH-env rollout (the handover from reset
    states moved by q ± 0.05, q̇ ± 0.05 so the envs differ; the randomized
    scene from the reset of RANDOMIZED_SEED + 2), pre_tick applied, for the
    first B envs, B in RAGGED and BATCH."""
    env = envs.make(scene)
    params = env.gather_params()
    states = (perturbed_states(env, BATCH, 7, 0.05, 0.05)
              if scene == DUAL_HANDOVER else
              envs.make_batched_reset(env, BATCH, RANDOMIZED_SEED + 2)())
    states, _ = envs.make_batched_rollout(env, DUAL_K1_TICKS,
                                          with_aux=False)(states, params)
    if env.pre_tick is not None:
        states = env.pre_tick(states)
    out = {}
    for B in RAGGED + (BATCH,):
        q, qd, prm, ctxs, fk = _policy_inputs(env, _take(states, B), params)
        out[B] = policy_row_blocks_structured(env.policies, q, qd, prm, ctxs,
                                              fk=fk)
    return out


def phase_k1_dual(device) -> tuple[dict, dict, float]:
    """K1 at n = 18 (its own warp-per-env kernel) on both dual layouts
    against its plain version: random contiguous blocks and the real
    ticks' blocks (dual_tick_blocks, at their real strides; envs whose
    plain q̈ is not finite left out and counted) at B = 4096, 1, 7 and
    4093; one device kernel per call; timed at B = 4096 on the real blocks
    beside its bound and the einsum + torch.linalg.solve yardstick."""
    build = build_counts(K1_WIDE_SOURCE, "K1 n=18",
                         "pullback_resolve_wide_kernelILi18E")
    out, err = {}, 0.0
    for key, (layout, scene) in K1_DUAL_LAYOUTS.items():
        for B in (BATCH,) + RAGGED:
            tags, blocks = k1_layout_blocks(18 + B, B, 18, layout, device)
            err = max(err, k1_compare(tags, blocks, f"{key} (n=18) random "
                                      f"contiguous blocks, B={B}"))
        real = dual_tick_blocks(scene)
        for B, (tags, blocks) in real.items():
            rows = tuple((t, b[0].shape[1] if t != "identity" else 0)
                         for t, b in zip(tags, blocks))
            check(rows == layout, f"K1 {key}: real tick layout {rows}")
            err = max(err, k1_compare(tags, blocks, f"{key} (n=18) real "
                                      f"tick {DUAL_K1_TICKS} ticks in, "
                                      f"B={B}", nonfinite_ok=True))
        tags, blocks = real[BATCH]

        def call():
            return cuda_resolve.pullback_resolve_structured(tags, blocks)
        per_call = device_launches(call, "pullback_resolve_wide_kernel",
                                   f"K1 {key}")
        check(per_call == 1, f"K1 {key}: not one launch per wrapper call")
        rec = dict(n=18, scene=scene, layout=[list(r) for r in layout],
                   strides={f"{t} {k}": blk[0].stride() for k, (t, blk) in
                            enumerate(zip(tags, blocks)) if t != "identity"},
                   device_launches_per_call=per_call, ms=time_ms(call),
                   device_ms=time_ms(call, lead=True),
                   plain_ms=time_ms(lambda: cuda_resolve.
                                    pullback_resolve_structured_plain(
                                        tags, blocks)),
                   library_ms=time_ms(lambda: k1_library(tags, blocks)))
        rec["bound_ms"], rec["bound_by"] = k1_bound(tags, blocks)
        log(f"K1 {key} (n=18) times at B={BATCH} on the real tick's blocks "
            f"{rec['strides']}: wrapper {rec['ms']:.4f} ms (device alone "
            f"{rec['device_ms']:.4f} ms), plain {rec['plain_ms']:.4f} ms, "
            f"einsum+linalg.solve {rec['library_ms']:.4f} ms, bound "
            f"{rec['bound_ms']:.6f} ms ({rec['bound_by']})")
        out[key] = rec
    return out, build, err


def phase_k3_dual(device) -> tuple[dict, float]:
    """K3 on the dual-arm Panda (F = 26, n = 18) against its plain version
    at B = 4096, 1, 7 and 4093; one device kernel per call; timed at
    B = 4096 beside its bound; then the Panda's K3 timed again."""
    model = robots.dual_panda()
    shared = _build.c_function("rmp_fk_derivatives_shared_bytes",
                               [ctypes.c_int, ctypes.c_int])
    err = 0.0
    for B in (BATCH,) + RAGGED:
        q, qd = k3_inputs(model, B, device)
        got = cuda_fk.fk_derivatives_batched(model, q, qd)
        want = fk_derivatives(model, q, qd)
        torch.cuda.synchronize()
        for what, g, w in zip(("T16", "Td16", "J16", "c16"), got, want):
            check(g.shape == w.shape, f"K3 dual {what}: shape")
            e = float((g - w).abs().max())
            log(f"K3 dual {what}, B={B}: max|kernel - plain| {e:.3e} (atol "
                f"{K3_ATOL})")
            check(e <= K3_ATOL, f"K3 dual {what}: disagrees with plain "
                  f"version")
            err = max(err, e)
    q, qd = k3_inputs(model, BATCH, device)

    def call():
        return cuda_fk.fk_derivatives_batched(model, q, qd)
    per_call = device_launches(call, "fk_derivatives_kernel", "K3 dual")
    check(per_call == 1, "K3 dual: not one launch per wrapper call")
    panda = robots.franka_panda()
    pq, pqd = k3_inputs(panda, BATCH, device)
    rec = dict(frames=model.n_frames, n=model.n_q,
               dynamic_smem_bytes=shared(model.n_frames, model.n_q),
               device_launches_per_call=per_call, ms=time_ms(call),
               device_ms=time_ms(call, lead=True),
               plain_ms=time_ms(lambda: fk_derivatives(model, q, qd)),
               panda_device_ms=time_ms(lambda: cuda_fk.fk_derivatives_batched(
                   panda, pq, pqd), lead=True))
    rec["bound_ms"], rec["bound_by"] = k3_bound(model, BATCH)
    log(f"K3 dual (F={model.n_frames}, n={model.n_q}) times at B={BATCH}: "
        f"wrapper {rec['ms']:.4f} ms (device alone {rec['device_ms']:.4f} "
        f"ms), plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.6f} ms "
        f"({rec['bound_by']}), dynamic shared memory "
        f"{rec['dynamic_smem_bytes']} bytes; the Panda's K3 again: device "
        f"{rec['panda_device_ms']:.4f} ms")
    return rec, err


def phase_dual_golden() -> dict:
    """The committed dual handover golden (tests/golden/dual_handover_30t.npz:
    q, q̇ and solved_count after 30 ticks at B = 2) on the card: q within
    DUAL_GOLDEN_ATOL, solved_count exact."""
    data_ = np.load(os.path.join(ROOT, "tests", "golden",
                                 "dual_handover_30t.npz"))
    env = envs.make(DUAL_HANDOVER)
    final, _ = envs.make_batched_rollout(env, 30, with_aux=False)(
        envs.make_batched_reset(env, 2)(), env.gather_params())
    rec = dict(q=float(np.abs(final.sim.q.cpu().numpy() - data_["q"]).max()),
               qd=float(np.abs(final.sim.qd.cpu().numpy()
                               - data_["qd"]).max()),
               solved_count=final.solved_count.cpu().tolist())
    log(f"dual handover golden on the card: {json.dumps(rec)} (q atol "
        f"{DUAL_GOLDEN_ATOL}, solved_count {data_['solved_count'].tolist()})")
    check(rec["q"] <= DUAL_GOLDEN_ATOL, "dual handover golden: q")
    check(rec["solved_count"] == data_["solved_count"].tolist(),
          "dual handover golden: solved_count")
    return rec


def phase_k4_dual() -> dict:
    """K4 on the randomized dual scene's own operands (hull tier, BATCH
    envs 20 ticks in: every (link, obstacle slot) pair, cold, 10
    iterations, as its context_fn queries them) with phase 6's distance
    limits and its witnesses held as k4_in_loop holds random cylinders
    (k4_evidence's cap_fault form, each pair in its ball), timed beside its
    bound."""
    env = envs.make(DUAL_RANDOMIZED)
    env.collision_geometry = "hull"
    states = envs.make_batched_reset(env, BATCH, RANDOMIZED_SEED + 3)()
    states, _ = envs.make_batched_rollout(env, 20, with_aux=False)(
        states, env.gather_params())
    T_all = kinematics.fk_all(env.model, states.sim.q)
    obstacles = states.sim.obstacles
    cap = collision.robot_obstacle_distances(env.model, T_all, obstacles)
    _, ops = collision.gjk_operands(env.model, T_all, obstacles, cap,
                                    top_m=obstacles.count)
    return k4_operands_check(ops, data.COLD_ITERS,
                             f"K4 {DUAL_RANDOMIZED} operands, cold",
                             cap_fault=True, witness_quantile=False)


def phase_slice9(card: str, device) -> dict:
    """Phase 15: K1 at n = 18 and K3 on the dual-arm Panda against their
    plain versions, the dual handover golden on the card, K4 on the
    randomized dual scene's operands, its 4096-env x 300-tick rollouts in
    both tiers with their statistics, the handover's 4096 x 150 rollout,
    and GPU/CPU parity of both scenes (and of franka/03 in the hull tier).
    Every part runs before the statistics' and parities' checks."""
    parts, t0 = {}, time.perf_counter()
    k1, k1_build, k1_err = phase_k1_dual(device)
    k3, k3_err = phase_k3_dual(device)
    golden = phase_dual_golden()
    k4 = phase_k4_dual()
    parts["kernels"], t0 = time.perf_counter() - t0, time.perf_counter()
    failed: list = []
    paths = {f"{DUAL_RANDOMIZED} ({g})": randomized_path(
        card, g, failed, scene=DUAL_RANDOMIZED, k3_per_tick=1,
        reports=DUAL_REPORTS) for g in ("capsule", "hull")}
    paths[DUAL_HANDOVER] = phase_main_path(card, "capsule", DUAL_HANDOVER,
                                           ticks=DUAL_HANDOVER_TICKS,
                                           method=None)
    parts["paths"], t0 = time.perf_counter() - t0, time.perf_counter()
    parity = {g: randomized_parity(g, failed, DUAL_RANDOMIZED, *DUAL_PARITY[g])
              for g in ("capsule", "hull")}
    parity["handover (hull)"] = randomized_parity(
        "hull", failed, DUAL_HANDOVER, *HANDOVER_HULL_PARITY,
        spread=(0.1, 0.05))
    parity["witness_q"] = phase_new_scene_parity(
        [(DUAL_HANDOVER, False), ("franka/03_self_avoidance", False, "hull")])
    parts["parity"] = time.perf_counter() - t0
    log(f"phase 15 parts (s): {json.dumps(parts)}")
    check(not failed, "; ".join(failed))
    return dict(k1=k1, k1_build=k1_build, k1_err=k1_err, k3=k3,
                k3_err=k3_err, golden=golden, k4=k4, paths=paths,
                parity=parity)

# ------------------------------------ phase 16: the tenth slice's paths ---

PROVOKE = "franka/02_provoke_collision"
PROVOKE_TICKS = 120
# tests/test_contact.py's criterion: the contact-free ghost pierces the
# cylinder past PROVOKE_GHOST_DEPTH, and contact keeps the arm's least
# distance at least PROVOKE_MARGIN above the ghost's
PROVOKE_GHOST_DEPTH = -0.004
PROVOKE_MARGIN = 0.002
# K3 per contact tick: the policies' FK and one per physics substep
PROVOKE_K3_PER_TICK = 1 + 10
PIERCE_TICKS = 29            # the ghost's deepest tick (CPU run): parity start
# (envs, ticks) from the piercing states; 5 ticks before the fifteenth slice
CONTACT_PARITY = (128, 3)
IMPULSE_B = 128
IMPULSE_DT = 0.005
IMPULSE_LEAN = 0.8           # rad on the shoulder: the arm starts at the floor
IMPULSE_FALL = 25            # substeps of the collapse on the card first
IMPULSE_COMPARE = 5          # then these, card against CPU
IMPULSE_ATOL = 1e-3          # |Δq|, |Δq̇| after them ...
IMPULSE_SPREAD = 5.0         # ... or this many times the env's rounding move
KKT_SWEEPS = 1500            # tests/test_contact.py's KKT check
HULL_MODELS = {"two_joint/05_obstacle_avoidance": "two-joint (3, 48)",
               "ur5/02_obstacle_avoidance": "UR5 (6, 130)"}
HULL_MODEL_SCENES = ("two_joint/05_obstacle_avoidance",
                     "two_joint/05_obstacle_avoidance_variant",
                     "ur5/02_obstacle_avoidance")
HULL_MODEL_PARITY = (128, 3)     # 10, then 5 ticks before the fifteenth
K1_UR5_HULL_LAYOUT = (("dense", 3), ("identity", 0), ("dense", 18))
# the trained reach criteria of tests/test_neural.py: (ticks, the bound on
# the mean final EE-goal distance, in x and y only)
NEURAL_REACH = {"two_joint/neural_reach": (80, 0.05, True),
                "franka/neural_reach": (60, 0.1, False)}
NEURAL_CLUTTER = "franka/neural_clutter"
NEURAL_REPORTS = {"capsule": "reports/eval_neural_clutter.json"}
DISCRETE[NEURAL_CLUTTER] = DISCRETE[RANDOMIZED]
# halved in the thirteenth slice and again in the fifteenth, for time
# (12, 12, 15 ticks, then 6, 6, 8)
NEURAL_PARITY = {"two_joint/neural_reach": (128, 3),
                 "franka/neural_reach": (128, 3),
                 NEURAL_CLUTTER: (128, 4)}


def k4_tie_share(ops: dict, iters: int) -> dict:
    """The share of K4's pairs whose link support ties (at least two of the
    link's distinct rows at the maximum dot, in torch's float32), at the
    first support (direction -d0) and at the last (-(pa - pb) of the
    kernel's answer): the pairs where the kernel's mask average meets a
    tie."""
    verts = ops["verts"]
    rows = cuda_gjk.distinct_rows(verts)
    pa, pb, _ = cuda_gjk.gjk_hull_obstacles(**ops, iters=iters)

    def share(d):                          # d (L, M, 3, B), world
        local = torch.einsum("lijb,lmib->lmbj", ops["R"], d)   # R^T d
        tied = []
        for link, n_rows in enumerate(rows):
            dots = local[link] @ verts[link, :n_rows].T        # (M, B, V)
            top = dots.amax(dim=-1, keepdim=True)
            tied.append((dots == top).sum(dim=-1) >= 2)
        return float(torch.stack(tied).double().mean())
    return dict(first_support=share(-ops["d0"]),
                last_support=share(pb - pa), distinct_rows=rows)


def phase_k4_models() -> dict:
    """K4 on the two-joint robot's and the UR5's main-path warm operands
    (k4_main_path_operands: the hull tier at BATCH envs, 20 ticks in, the
    warm carry, 4 iterations) against its plain version with phase 6's
    limits and k4_evidence's cap_fault form, timed beside
    k4_bound_needed, with the share of pairs whose support ties."""
    out = {}
    for scene, table in HULL_MODELS.items():
        ops, iters = k4_main_path_operands(scene, method=None)
        check(iters == data.WARM_ITERS, f"K4 on {scene}: {iters} iterations")
        rec = k4_operands_check(ops, iters, f"K4 {scene} operands, {iters} "
                                f"iterations", cap_fault=True)

        def call():
            return cuda_gjk.gjk_hull_obstacles(**ops, iters=iters)
        rec["device_launches_per_call"] = device_launches(
            call, "gjk_hull_kernel", f"K4 {table}")
        check(rec["device_launches_per_call"] == 1,
              f"K4 {table}: not one launch per wrapper call")
        rec["ties"] = k4_tie_share(ops, iters)
        rec.update(table=table, pairs=list(ops["p0"].shape[:2]) + [BATCH])
        log(f"K4 {table} on {scene}: share of pairs whose support ties "
            f"{json.dumps(rec['ties'])}")
        out[scene] = rec
    return out


def phase_k1_slice10(device) -> tuple[dict, float]:
    """K1 on ur5/02's real tick in the hull tier (real_tick_blocks: dense 3,
    an identity and the grouped avoidance's 18 rows, n = 6) and on
    franka/neural_clutter's real tick (phase_k1_randomized: dense 3, three
    identities and the learned leaf's 80 scalar rows) against its plain
    version at B = 4096, 1, 7 and 4093; one device kernel per call; timed
    beside its bound."""
    env = envs.make("ur5/02_obstacle_avoidance")
    env.collision_geometry = "hull"
    err = 0.0
    for B in RAGGED + (BATCH,):
        tags, blocks = real_tick_blocks(env, B, 12)
        rows = tuple((t, b[0].shape[1] if t != "identity" else 0)
                     for t, b in zip(tags, blocks))
        check(rows == K1_UR5_HULL_LAYOUT, f"K1 ur5/02 hull layout {rows}")
        err = max(err, k1_compare(tags, blocks, f"ur5/02 (hull) real tick, "
                                  f"B={B}"))

    def call():
        return cuda_resolve.pullback_resolve_structured(tags, blocks)
    per_call = device_launches(call, "pullback_resolve_kernel",
                               "K1 ur5/02 (hull)")
    check(per_call == 1, "K1 ur5/02 (hull): not one launch per wrapper call")
    rec = dict(n=6, scene="ur5/02_obstacle_avoidance", geometry="hull",
               layout=[list(r) for r in K1_UR5_HULL_LAYOUT],
               device_launches_per_call=per_call, ms=time_ms(call),
               device_ms=time_ms(call, lead=True),
               plain_ms=time_ms(lambda: cuda_resolve.
                                pullback_resolve_structured_plain(tags,
                                                                  blocks)),
               library_ms=time_ms(lambda: k1_library(tags, blocks)))
    rec["bound_ms"], rec["bound_by"] = k1_bound(tags, blocks)
    log(f"K1 ur5/02 (hull, n=6) times at B={BATCH}: wrapper "
        f"{rec['ms']:.4f} ms (device alone {rec['device_ms']:.4f} ms), plain "
        f"{rec['plain_ms']:.4f} ms, einsum+linalg.solve "
        f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.6f} ms "
        f"({rec['bound_by']})")
    neural, neural_err = phase_k1_randomized(device, NEURAL_CLUTTER,
                                             "neural_clutter")
    return dict(neural, **{"ur5/02 (hull)": rec}), max(err, neural_err)


def _least_clearance(env, states) -> torch.Tensor:
    """(B,) the least capsule distance of the arm to the scene's
    obstacles."""
    T_all = kinematics.fk_all(env.model, states.sim.q)
    return collision.robot_obstacle_distances(
        env.model, T_all, states.sim.obstacles)[3].amin(dim=(1, 2))


def provoke_run(env, params, counted: bool):
    """PROVOKE_TICKS ticks of `env` at BATCH envs from its reset, tick by
    tick, with each env's least clearance to the cylinder after every tick
    (a running minimum on the card, no wait). counted: every launch counter
    zeroed just before and read after. -> (least (B,) on the CPU, the final
    states, seconds, launches)."""
    step = make_batched_control_step(env)
    states = envs.make_batched_reset(env, BATCH)()
    least = torch.full((BATCH,), float("inf"), device=states.sim.q.device)
    torch.cuda.synchronize()
    if counted:
        for fn in COUNTERS.values():
            fn.launches = 0
    t0 = time.perf_counter()
    for _ in range(PROVOKE_TICKS):
        states, _ = step(states, params)
        least = torch.minimum(least, _least_clearance(env, states))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    return least.cpu(), states, seconds, launches


@spent()
def provoke_path(card: str, failed: list) -> tuple[dict, dict, dict]:
    """franka/02 at BATCH identical envs x PROVOKE_TICKS ticks, with contact
    (penalty forces in each of the 10 substeps) and as the contact-free
    ghost: tests/test_contact.py's criterion on every env (the ghost's
    least clearance below PROVOKE_GHOST_DEPTH, the contact run's at least
    PROVOKE_MARGIN above it), q finite; K3 PROVOKE_K3_PER_TICK times per
    contact tick, once per ghost tick, no other kernel ('pinv'); the
    synchronizing calls of one contact tick; the contact tick's time (its
    loop holds the clearance query too) and its 10-tick trace; K3 on the
    contact run's final state against its plain version, timed beside its
    bound. -> (launches, path record, K3 record)."""
    what = f"{PROVOKE} (contact)"
    env = envs.make(PROVOKE)
    check(env.contact and env.resolve_method == "pinv",
          f"{PROVOKE}: contact {env.contact}, '{env.resolve_method}'")
    ghost = dataclasses.replace(env, contact=False)
    params = env.gather_params()
    warm = envs.make_batched_reset(env, BATCH)()
    warm, _ = envs.make_batched_rollout(env, WARMUP_TICKS, with_aux=False)(
        warm, params)
    syncs = sync_free_tick(env, warm, params, what)
    # torch.linalg.pinv's batched SVD checks cuSOLVER's info on the host:
    # the 'pinv' resolve's one wait per tick, which no torch SVD avoids
    pinv_line = next(i + 1 for i, line in enumerate(
        inspect.getsource(core).splitlines()) if "torch.linalg.pinv(" in line)
    svd = [x for x in syncs
           if x.startswith(f"rmp_tpu_torch/core.py:{pinv_line} ")]
    other = [x for x in syncs if x not in svd]
    if other:
        failed.append(f"{what}: synchronizing calls besides the 'pinv' "
                      f"resolve's SVD: {other[:3]}")
    least_ghost, _, ghost_s, ghost_launches = provoke_run(ghost, params,
                                                          True)
    least, final, seconds, launches = provoke_run(env, params, True)
    tick_ms = seconds * 1e3 / PROVOKE_TICKS
    log(f"{what}: {BATCH} envs x {PROVOKE_TICKS} ticks in {seconds:.3f} s = "
        f"{tick_ms:.3f} ms per tick with the clearance query (the ghost: "
        f"{ghost_s * 1e3 / PROVOKE_TICKS:.3f} ms) [{card}]")
    log(f"{what} launches: {launches}; the ghost's: {ghost_launches}")
    for counts, k3, run in ((launches, PROVOKE_K3_PER_TICK, "contact"),
                            (ghost_launches, 1, "ghost")):
        for name, count in counts.items():
            want = (PROVOKE_TICKS * k3 if name == "fk_derivatives_batched"
                    else 0)
            check(count == want, f"{PROVOKE} ({run}): {name} launched "
                  f"{count} times in {PROVOKE_TICKS} ticks, want {want}")
    check(bool(torch.isfinite(final.sim.q).all()), f"{what}: non-finite q")
    rec = dict(scene=PROVOKE, envs=BATCH, ticks=PROVOKE_TICKS,
               seconds=seconds, tick_ms=tick_ms,
               ghost_tick_ms=ghost_s * 1e3 / PROVOKE_TICKS,
               control_steps_per_s=BATCH * PROVOKE_TICKS / seconds,
               sync_calls_per_tick=len(syncs), sync_calls_svd=len(svd),
               least_clearance_ghost=[float(least_ghost.min()),
                                      float(least_ghost.max())],
               least_clearance_contact=[float(least.min()),
                                        float(least.max())])
    log(f"{what} criterion: the ghost's least clearance "
        f"{rec['least_clearance_ghost']} (below {PROVOKE_GHOST_DEPTH}), "
        f"with contact {rec['least_clearance_contact']} (at least "
        f"{PROVOKE_MARGIN} above the ghost's), [min, max] over the envs")
    if not bool((least_ghost < PROVOKE_GHOST_DEPTH).all()):
        failed.append(f"{what}: the ghost does not pierce the cylinder")
    if not bool((least > least_ghost + PROVOKE_MARGIN).all()):
        failed.append(f"{what}: contact does not hold the arm back")
    # two ticks: a contact tick's ~15,000 launches make a 10-tick trace
    # slow to process
    rec["trace"] = profile_ticks(env, final, params, tick_ms, n_ticks=2)
    log(f"{what} trace: {json.dumps(rec['trace'])}")

    # K3 on the contact path's own inputs
    model, q, qd = env.model, final.sim.q.contiguous(), final.sim.qd
    got = cuda_fk.fk_derivatives_batched(model, q, qd)
    want = fk_derivatives(model, q, qd)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    log(f"K3 on {PROVOKE}'s final state: max|kernel - plain| {err:.3e} "
        f"(atol {K3_ATOL})")
    check(err <= K3_ATOL, f"K3 on {PROVOKE}: disagrees with plain version")

    def call():
        return cuda_fk.fk_derivatives_batched(model, q, qd)
    k3 = dict(max_abs_err=err, ms=time_ms(call),
              device_ms=time_ms(call, lead=True),
              plain_ms=time_ms(lambda: fk_derivatives(model, q, qd)),
              library_ms=None)
    k3["bound_ms"], k3["bound_by"] = k3_bound(model, BATCH)
    return launches, rec, k3


@spent()
def provoke_parity(failed: list) -> dict:
    """franka/02's GPU/CPU parity where contact acts: from provoke_start,
    randomized_parity's screens over CONTACT_PARITY ticks with contact."""
    return randomized_parity("capsule", failed, PROVOKE, *CONTACT_PARITY,
                             start_of="provoke_start")


def provoke_start():
    """The CPU's ghost of franka/02 (one env) PIERCE_TICKS ticks in, where
    it pierces the cylinder, copied to CONTACT_PARITY envs moved by
    q ± 0.02, q̇ ± 0.05 (seeded)."""
    B = CONTACT_PARITY[0]
    env = envs.make(PROVOKE, device="cpu")
    ghost = dataclasses.replace(env, contact=False)
    state = envs.make_batched_reset(ghost, 1)()
    step = envs.make_control_step(ghost)
    for _ in range(PIERCE_TICKS):
        state, _ = step(state, ghost.gather_params())
    rng = np.random.default_rng(PARITY_SEED)
    start = envs.make_batched_reset(env, B)()
    q = state.sim.q + torch.tensor(rng.uniform(-0.02, 0.02, (B, 9)),
                                   dtype=torch.float32)
    qd = state.sim.qd + torch.tensor(rng.uniform(-0.05, 0.05, (B, 9)),
                                     dtype=torch.float32)
    start = dataclasses.replace(start, sim=dataclasses.replace(
        start.sim, q=q, qd=qd))
    depth = float(-_least_clearance(env, start).min())
    log(f"{PROVOKE} parity start: the ghost {PIERCE_TICKS} ticks in, the "
        f"deepest of {B} moved envs {depth:.4f} m inside the cylinder")
    return start


def impulse_step(model, state):
    """One physics step at IMPULSE_DT of the free-falling arm under impulse
    contacts: the commanded q̈ is FD(q, q̇, 0), so the torque route's
    τ = ID(q, q̇, q̈) is zero up to rounding (tests/test_contact.py:113's
    collapse, through physics_step; line 148's zero q̈ in torque mode is
    gravity-compensated and never falls)."""
    fall = dynamics.forward_dynamics(model, state.q, state.qd,
                                     torch.zeros_like(state.q))
    return physics_step(model, state, fall, IMPULSE_DT, contact=True,
                        contact_model="impulse")


@spent()
def impulse_on_card(failed: list, device) -> dict:
    """The impulse contact model on the card. The collapsing arm
    (impulse_step: zero torque, ground contact) at IMPULSE_B envs from the
    ready pose leaned IMPULSE_LEAN forward and moved by q ± 0.2, at the
    floor: IMPULSE_FALL substeps on the card, then IMPULSE_COMPARE
    substeps on the card and on the CPU from the same state, at least a
    quarter of the envs in contact. The projected Gauss-Seidel's 12 sweeps
    leave λ short of convergence, so rounding moves q̇: each env's gap in
    q and q̇ is held to max(IMPULSE_ATOL, IMPULSE_SPREAD x the larger move
    of the CPU run from a start moved by one ulp and of a float64 run
    (plain_kernels)). Then tests/test_contact.py's KKT check on the card:
    its 12 random penetrating scenes (seed 3) in one batch, KKT_SWEEPS
    sweeps with friction: λ_n >= 0, the regularised normal residual
    >= -5e-3 and within 5e-3 of 0 where λ_n > 1e-6, |λ_t| <= μ λ_n +
    1e-6."""
    model = robots.franka_panda()
    rng = np.random.default_rng(13)
    q0 = robots.PANDA_Q_READY + rng.uniform(-0.2, 0.2, (IMPULSE_B, 9))
    q0[:, 1] += IMPULSE_LEAN
    q0 = torch.tensor(q0, dtype=torch.float32, device=device)
    state = SimState(q=q0, qd=torch.zeros_like(q0),
                     t=torch.zeros(IMPULSE_B, device=device))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(IMPULSE_FALL):
        state = impulse_step(model, state)
    torch.cuda.synchronize()
    substep_ms = (time.perf_counter() - t0) * 1e3 / IMPULSE_FALL
    cpu = _tree_map(lambda t: t.cpu() if isinstance(t, torch.Tensor) else t,
                    state)
    rows = contact.contact_rows(model, cpu.q, cpu.qd, None, True)
    in_contact = int((rows[1] > 0).any(dim=1).sum())
    up = torch.tensor(float("inf"))
    runs = dict(card=state, cpu=cpu, float64=_as_dtype(cpu, torch.float64),
                ulp=dataclasses.replace(cpu, q=torch.nextafter(cpu.q, up),
                                        qd=torch.nextafter(cpu.qd, up)))
    for _ in range(IMPULSE_COMPARE):
        for key in ("card", "cpu", "ulp"):
            runs[key] = impulse_step(model, runs[key])
        with plain_kernels(float64=True):
            runs["float64"] = impulse_step(model, runs["float64"])

    def gap(key):                                 # (B,) against the CPU
        r, c = runs[key], runs["cpu"]
        return torch.maximum(
            (r.q.cpu().double() - c.q.double()).abs().amax(dim=1),
            (r.qd.cpu().double() - c.qd.double()).abs().amax(dim=1))
    card, move = gap("card"), torch.maximum(gap("ulp"), gap("float64"))
    limit = torch.clamp(IMPULSE_SPREAD * move, min=IMPULSE_ATOL)
    T_all = kinematics.fk_all(model, runs["cpu"].q)
    p0, p1, radius, _ = collision.link_world_capsules_all(model, T_all)
    clearance = float((torch.minimum(p0[..., 2], p1[..., 2]) - radius).min())
    rec = dict(envs=IMPULSE_B, substeps=IMPULSE_FALL + IMPULSE_COMPARE,
               substep_ms=substep_ms, envs_in_contact=in_contact,
               max_card_vs_cpu=float(card.max()),
               max_rounding_move=float(move.max()),
               envs_within_atol=int((card <= IMPULSE_ATOL).sum()),
               envs_over_limit=int((card > limit).sum()),
               max_qd=float(runs["cpu"].qd.abs().max()),
               least_ground_clearance=clearance)
    log(f"impulse contacts, collapsing arm: {json.dumps(rec)} (each env "
        f"within max({IMPULSE_ATOL}, {IMPULSE_SPREAD} x its rounding move) "
        f"after {IMPULSE_COMPARE} substeps)")
    if in_contact < IMPULSE_B // 4:
        failed.append(f"impulse collapse: {in_contact} envs in contact")
    if rec["envs_over_limit"]:
        failed.append(f"impulse collapse: card against CPU {rec}")

    # the KKT certificate of tests/test_contact.py's scenes
    rng = np.random.default_rng(3)
    draws = [(rng.uniform(-1.2, 1.2, 9), rng.uniform(-1.0, 1.0, 9),
              rng.uniform([-0.4, -0.4, 0.0], [0.6, 0.4, 0.8]),
              rng.uniform(0.1, 0.25)) for _ in range(12)]

    def f32(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32,
                            device=device)
    q, qd = f32([d[0] for d in draws]), f32([d[1] for d in draws])
    c = f32([d[2] for d in draws])[:, None]
    obs = collision.ObstacleSet(c, c, f32([d[3] for d in draws])[:, None])
    mu, dt, cfm = 0.5, 0.01, 1e-3
    J_n, depth, *_ = contact.contact_rows(model, q, qd, obs, True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qd_post, lam = contact.impulse_contact_velocity(
        model, q, qd, dt, obstacles=obs, friction=mu, iterations=KKT_SWEEPS,
        cfm=cfm, return_impulses=True)
    torch.cuda.synchronize()
    kkt_s = time.perf_counter() - t0
    C = depth.shape[1]
    J_n, depth, lam, qd_post = (x.double().cpu() for x in
                                (J_n, depth, lam, qd_post))
    lam_n, lam_t = lam[:, :C], lam[:, C:].reshape(-1, C, 2)
    resid = (torch.einsum("bcn,bn->bc", J_n, qd_post)
             - 0.2 * torch.clamp(depth - 1e-3, min=0.0) / dt + cfm * lam_n)
    act = depth > 0
    pushing = act & (lam_n > 1e-6)
    kkt = dict(scenes=int(act.any(dim=1).sum()), seconds=kkt_s,
               least_normal_impulse=float(lam_n[act].min()),
               least_residual=float(resid[act].min()),
               complementarity=float(resid[pushing].abs().max()),
               coulomb_excess=float((lam_t.abs().amax(dim=-1)
                                     - mu * lam_n)[act].max()))
    log(f"impulse KKT on the card ({KKT_SWEEPS} sweeps, 12 scenes in one "
        f"batch): {json.dumps(kkt)}")
    if (kkt["scenes"] < 3 or kkt["least_normal_impulse"] < 0
            or kkt["least_residual"] < -5e-3 or kkt["complementarity"] > 5e-3
            or kkt["coulomb_excess"] > 1e-6):
        failed.append(f"impulse KKT on the card: {kkt}")
    return dict(collapse=rec, kkt=kkt)


@spent()
def neural_reach_path(card: str, scene: str, failed: list
                      ) -> tuple[dict, dict]:
    """A learned reach scene: phase_main_path's BATCH x TICKS rollout (K3
    once per tick, 'cholesky', no other kernel) and its trace, then
    tests/test_neural.py's criterion on all BATCH envs of another reset
    (seed 7): the mean EE-goal distance (in x and y on the two-joint robot)
    after its ticks under its bound."""
    launches, rec = phase_main_path(card, "capsule", scene, method=None)
    ticks, bound, xy = NEURAL_REACH[scene]
    env = envs.make(scene)
    final, aux = envs.make_batched_rollout(env, ticks)(
        envs.make_batched_reset(env, BATCH, 7)(), env.gather_params())
    axes = slice(0, 2) if xy else slice(0, 3)
    d = torch.linalg.vector_norm(aux["ee"][:, -1, axes]
                                 - final.sim.goal[:, axes], dim=-1)
    rec["criterion"] = dict(ticks=ticks, envs=BATCH,
                            mean_final_distance=float(d.mean()), bound=bound,
                            solved_share=float(final.solved_count.float()
                                               .mean()),
                            finite=bool(torch.isfinite(d).all()))
    log(f"{scene} trained criterion: {json.dumps(rec['criterion'])}")
    if not (rec["criterion"]["finite"]
            and rec["criterion"]["mean_final_distance"] < bound):
        failed.append(f"{scene}: trained criterion {rec['criterion']}")
    return launches, rec


def phase_slice10(card: str, device) -> dict:
    """Phase 16: K4 on the two-joint robot's and the UR5's hull tables, K1
    on ur5/02's hull tick and franka/neural_clutter's tick, franka/02 with
    contact and as the ghost at 4096 envs, the impulse model on the card,
    the hull-tier rollouts of two_joint/05, its variant and ur5/02, the
    learned scenes' rollouts with their criteria and statistics, and GPU/CPU
    parity of every new scene behind the screens. Every part runs before
    the criteria's, statistics' and parities' checks."""
    times = {}
    t0 = time.perf_counter()
    k4 = phase_k4_models()
    k1, k1_err = phase_k1_slice10(device)
    times["kernels"] = time.perf_counter() - t0
    failed: list = []
    t0 = time.perf_counter()
    provoke_launches, provoke, k3 = provoke_path(card, failed)
    paths = {PROVOKE: (provoke_launches, provoke)}
    impulse = impulse_on_card(failed, device)
    times["contact"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for scene in HULL_MODEL_SCENES:
        paths[f"{scene} (hull)"] = phase_main_path(card, "hull", scene,
                                                   PATH_TICKS, method=None)
    times["hull"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for scene in NEURAL_REACH:
        paths[scene] = neural_reach_path(card, scene, failed)
    paths[NEURAL_CLUTTER] = randomized_path(card, "capsule", failed,
                                            scene=NEURAL_CLUTTER,
                                            reports=NEURAL_REPORTS)
    times["neural"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    parity = {PROVOKE: provoke_parity(failed)}
    for scene in HULL_MODEL_SCENES:
        parity[f"{scene} (hull)"] = randomized_parity(
            "hull", failed, scene, *HULL_MODEL_PARITY, spread=(0.1, 0.05))
    for scene, (B, ticks) in NEURAL_PARITY.items():
        parity[scene] = randomized_parity("capsule", failed, scene, B, ticks)
    times["parity"] = time.perf_counter() - t0
    log(f"phase 16 parts (s): {json.dumps(times)}")
    check(not failed, "; ".join(failed))
    return dict(k4=k4, k1=k1, k1_err=k1_err, k3=k3, paths=paths,
                impulse=impulse, parity=parity, seconds=times)


# ------------------------------------- phase 17: gradients and training ---

GRAD_B, GRAD_TICKS = 128, 10      # rollout-gradient checks (envs, ticks)
# a card gradient against the CPU's: within GRAD_RTOL of its norm, or
# GRAD_SPREAD times the CPU's own distance to a float64 run
GRAD_RTOL, GRAD_SPREAD = 1e-3, 3.0
HULL_COSINE, HULL_RATIO = 0.999, (0.98, 1.02)   # tests/test_pallas_gjk.py
REMAT_RTOL = 1e-4
K4_GRAD_P99, K4_GRAD_MEDIAN = 1e-3, 1e-5         # x max(1, max|cotangent|)
K3_BACKWARD_REPS = 7              # its recomputed plain vjp takes 25-130 ms
REACH_DEFAULTS = dict(batch=128, ticks=50, steps=60, lr=3e-3, clip=1.0)
CLUTTER_DEFAULTS = dict(batch=1024, ticks=100, hidden=(32, 32), lr=2e-3,
                        steps=300, clip=1.0, env_clip=3.0)
DESCENT = dict(batch=32, ticks=25, steps=25, lr=3e-3)  # tests/test_neural.py
TUNE_TICKS = 20                   # tune_gains --geometry hull's horizon
# the clutter trainer's step without remat runs this many ticks (its graph
# grows with the ticks: 20.64 GB at the default 100 on an H100 80GB HBM3,
# PERF.md); with remat, the entry point's step at its defaults
CLUTTER_NO_REMAT_TICKS = 10     # 25 before the fifteenth slice
GRAD_SCENES = (   # (scene, geometry, resolve, fused_resolve, envs, ticks)
    (SCENE, "capsule", "solve", True, GRAD_B, GRAD_TICKS),
    (SCENE, "hull", "solve", True, GRAD_B, GRAD_TICKS),
    ("franka/01_target_rmp_only", "capsule", "cholesky", False, GRAD_B,
     GRAD_TICKS),
    ("two_joint/05_obstacle_avoidance", "hull", "cholesky", False, GRAD_B,
     GRAD_TICKS),
)


def plain_envelope_k4(verts, R, t, p0, p1, an, radius, is_cyl, d0,
                      iters: int = 10):
    """K4's plain version in any dtype with the kernel path's backward, the
    envelope rule: what plain_kernels(grad=True) puts in K4's place, so a
    float64 or plain-kernel gradient takes the card's derivative rule."""
    return cuda_gjk.GjkHullObstacles.apply(
        cuda_gjk.gjk_hull_obstacles_plain, iters, verts, R, t, p0, p1, an,
        radius, is_cyl, d0)


def _leaf(x, dtype=None):
    return x.detach().to(dtype or x.dtype).requires_grad_()


def _err(got, want) -> float:
    return float((got - want).abs().max())


def _screened(what, got, plain, wit, tol: float) -> dict:
    """A Function's cotangents `got` against autograd through the plain
    version `plain`, each held to its float64 witness `wit`: within
    tol x max(1, max|wit|), or twice the plain version's own distance to
    the witness."""
    rec = dict(max_vs_plain=0.0, max_vs_float64=0.0, plain_vs_float64=0.0)
    for k, (g, p, w) in enumerate(zip(got, plain, wit)):
        if g is None and p is None:
            continue
        w = w.to(torch.float64)
        scale = max(1.0, float(w.abs().max()))
        e_fn, e_plain = _err(g.double(), w), _err(p.double(), w)
        check(bool(torch.isfinite(g).all()), f"{what}: cotangent {k} "
              f"non-finite")
        check(e_fn <= max(tol * scale, 2.0 * e_plain),
              f"{what}: cotangent {k} {e_fn:.3e} from float64 (plain "
              f"{e_plain:.3e}, limit {tol * scale:.3e})")
        rec["max_vs_plain"] = max(rec["max_vs_plain"], _err(g, p))
        rec["max_vs_float64"] = max(rec["max_vs_float64"], e_fn / scale)
        rec["plain_vs_float64"] = max(rec["plain_vs_float64"],
                                      e_plain / scale)
    log(f"{what}: {json.dumps(rec)}")
    return rec


def k1_backward(device) -> dict:
    """K1's Function at B = 4096 on scene 06's real-tick blocks (strided
    views, as the tick makes them), with a random x̄: its cotangents
    against autograd through the plain version and a float64 plain run;
    the backward, the transposed solve and its yardsticks timed."""
    env = envs.make(SCENE)
    tags, blocks = real_tick_blocks(env, BATCH, 1)
    B, n = BATCH, env.model.n_q
    g = torch.Generator(device=device).manual_seed(17)
    xbar = torch.randn(B, n, generator=g, device=device)

    def grads(entry, dtype):
        lv = [tuple(_leaf(x, dtype) for x in blk) for blk in blocks]
        x = entry(tags, lv)
        flat = [t for blk in lv for t in blk]
        return x, flat, torch.autograd.grad(x, flat, xbar.to(dtype),
                                            retain_graph=True)

    x, flat, got = grads(cuda_resolve.pullback_resolve_structured,
                         torch.float32)
    check(type(x.grad_fn).__name__ == "PullbackResolveBackward",
          f"K1: grad_fn {type(x.grad_fn).__name__}")
    _, _, plain = grads(cuda_resolve.pullback_resolve_structured_plain,
                        torch.float32)
    _, _, wit = grads(cuda_resolve.pullback_resolve_structured_plain,
                      torch.float64)
    rec = _screened("K1 backward (scene 06 real tick, B=4096)", got, plain,
                    wit, K1_TOL)
    A, _ = cuda_resolve.assemble_structured(tags, blocks)
    At = A.transpose(-1, -2)
    ts = cuda_resolve.transposed_solve(A, xbar, 0.0)
    ts_plain = cuda_resolve.pullback_resolve_structured_plain(
        ("identity",), [(At, xbar)])
    torch.cuda.synchronize()
    scale = max(1.0, float(ts_plain.abs().max()))
    ts_err = _err(ts, ts_plain)
    log(f"K1 transposed solve: max|kernel - plain| {ts_err:.3e} (limit "
        f"{K1_TOL * scale:.3e})")
    check(ts_err <= K1_TOL * scale, "K1 transposed solve disagrees with "
          "plain")
    leaves = [tuple(_leaf(t) for t in blk) for blk in blocks]
    leaf_flat = [t for blk in leaves for t in blk]
    x_keep = cuda_resolve.pullback_resolve_structured(tags, leaves)
    fwd_ms = time_ms(lambda: cuda_resolve.pullback_resolve_structured(
        tags, blocks), lead=True)
    bwd_ms = time_ms(lambda: torch.autograd.grad(x_keep, leaf_flat, xbar,
                                                 retain_graph=True),
                     lead=True)
    ts_ms = time_ms(lambda: cuda_resolve.transposed_solve(A, xbar, 0.0),
                    lead=True)
    plain_ms = time_ms(lambda: cuda_resolve.pullback_resolve_structured_plain(
        ("identity",), [(At, xbar)]))
    library_ms = time_ms(lambda: torch.linalg.solve(At, xbar))
    # the backward reads the blocks, x and x̄ and writes a cotangent of each
    # block tensor; the transposed solve reads A and x̄ and writes f̄, and
    # runs K1's LU
    block_floats = sum(t.numel() for blk in blocks for t in blk) / B
    bwd_bound = bound_ms(4.0 * (2 * block_floats + 2 * n) * B, 0.0)
    lu = sum((n - k - 1) * (2 * (n - k) + 3) for k in range(n)) + n * n + n
    ts_bound = bound_ms(4.0 * (n * n + 2 * n) * B, float(lu) * B)
    log(f"K1 backward at B={B}: forward {fwd_ms:.4f} ms, backward "
        f"{bwd_ms:.4f} ms (bound {bwd_bound[0]:.5f}, {bwd_bound[1]}); "
        f"transposed solve {ts_ms:.4f} ms (bound {ts_bound[0]:.5f}, "
        f"{ts_bound[1]}), plain LU on Aᵀ {plain_ms:.4f}, torch.linalg.solve "
        f"{library_ms:.4f}")
    return dict(rec, forward_ms=fwd_ms, backward_ms=bwd_ms,
                backward_bound_ms=bwd_bound[0], backward_bound_by=bwd_bound[1],
                transposed=dict(max_abs_err=ts_err, device_ms=ts_ms,
                                plain_ms=plain_ms, library_ms=library_ms,
                                bound_ms=ts_bound[0], bound_by=ts_bound[1]))


def k3_backward(model, what: str, device) -> dict:
    """K3's Function at B = 4096 with random cotangents on all four
    outputs: q, q̇ cotangents against autograd through the plain version
    and a float64 plain run; forward and backward timed."""
    q, qd = k3_inputs(model, BATCH, device)
    g = torch.Generator(device=device).manual_seed(18)
    F, n = model.n_frames, model.n_q
    cts = [torch.randn(*s, generator=g, device=device) for s in
           ((BATCH, F, 16), (BATCH, F, 16), (BATCH, F, 16, n),
            (BATCH, F, 16))]

    def grads(fn, dtype):
        a, b = _leaf(q, dtype), _leaf(qd, dtype)
        outs = fn(model, a, b)
        return outs, (a, b), torch.autograd.grad(
            outs, (a, b), [c.to(dtype) for c in cts], retain_graph=True)

    outs, ab, got = grads(cuda_fk.fk_derivatives_batched, torch.float32)
    check(all(type(o.grad_fn).__name__ == "FkDerivativesBackward"
              for o in outs), "K3: outputs without the Function's grad_fn")
    _, _, plain = grads(fk_derivatives, torch.float32)
    _, _, wit = grads(fk_derivatives, torch.float64)
    rec = _screened(f"K3 backward ({what}, B=4096)", got, plain, wit,
                    K3_ATOL)
    fwd_ms = time_ms(lambda: cuda_fk.fk_derivatives_batched(model, q, qd),
                     lead=True)
    bwd_ms = time_ms(lambda: torch.autograd.grad(outs, ab, cts,
                                                 retain_graph=True),
                     reps=K3_BACKWARD_REPS, lead=True)
    # reads q, q̇ and the four cotangents, writes q̄, q̇̄; at least the
    # forward's operations again (the recomputed plain forward)
    floats = 4 * n + F * 16 * (3 + n)
    bwd_bound = bound_ms(4.0 * floats * BATCH, float(k3_flops(model)) * BATCH)
    # at the clutter trainer's batch, where its 9 calls a tick recompute
    a, b = (_leaf(t[:CLUTTER_DEFAULTS["batch"]]) for t in (q, qd))
    sub_out = cuda_fk.fk_derivatives_batched(model, a, b)
    sub_cts = [c[:CLUTTER_DEFAULTS["batch"]] for c in cts]
    sub_ms = time_ms(lambda: torch.autograd.grad(sub_out, (a, b), sub_cts,
                                                 retain_graph=True),
                     reps=K3_BACKWARD_REPS, lead=True)
    log(f"K3 backward ({what}) at B={BATCH}: forward {fwd_ms:.4f} ms, "
        f"backward (plain vjp recomputed) {bwd_ms:.4f} ms, bound "
        f"{bwd_bound[0]:.5f} ms ({bwd_bound[1]}); at B="
        f"{CLUTTER_DEFAULTS['batch']} {sub_ms:.4f} ms")
    return dict(rec, forward_ms=fwd_ms, backward_ms=bwd_ms,
                backward_bound_ms=bwd_bound[0], backward_bound_by=bwd_bound[1],
                backward_ms_at_trainer_batch=sub_ms)


def _quantiles(x: torch.Tensor) -> tuple[float, float]:
    flat = x.flatten().double()
    return (float(torch.quantile(flat, 0.99)), float(flat.median()))


def k4_backward(device) -> dict:
    """K4's Function on the hull main path's own warm operands (4096 envs,
    the phase-8 path 20 ticks in) with random cotangents: its backward is
    the envelope rule on its own outputs (bit for bit), held at quantiles
    against the rule fed the plain forward's outputs, each against a
    float64 run of the plain forward and rule; forward and backward
    timed."""
    ops, iters = k4_main_path_operands()
    names = ("verts", "R", "t", "p0", "p1", "an", "radius", "is_cyl", "d0")
    diff = ("R", "t", "p0", "p1", "radius")
    args = {k: (_leaf(ops[k]) if k in diff else ops[k]) for k in names}
    outs = cuda_gjk.gjk_hull_obstacles(*(args[k] for k in names),
                                       iters=iters)
    check(type(outs[2].grad_fn).__name__ == "GjkHullObstaclesBackward",
          "K4: outputs without the Function's grad_fn")
    g = torch.Generator(device=device).manual_seed(19)
    cts = [torch.randn(*o.shape, generator=g, device=device) for o in outs]
    got = torch.autograd.grad(outs, [args[k] for k in diff], cts,
                              retain_graph=True)
    rule = ("R", "t", "p0", "p1")
    own = cuda_gjk.envelope_cotangents(*(ops[k] for k in rule),
                                       *(o.detach() for o in outs), *cts)
    plain_out = cuda_gjk.gjk_hull_obstacles_plain(
        *(ops[k] for k in names), iters)
    plain = cuda_gjk.envelope_cotangents(*(ops[k] for k in rule),
                                         *plain_out, *cts)
    o64 = {k: v.double() for k, v in ops.items()}
    wit = cuda_gjk.envelope_cotangents(
        *(o64[k] for k in rule),
        *cuda_gjk.gjk_hull_obstacles_plain(*(o64[k] for k in names), iters),
        *(c.double() for c in cts))
    rec = dict(max_vs_rule=0.0)
    for name, a, b, p, w in zip(diff, got, own, plain, wit):
        scale = max(1.0, float(w.abs().max()))
        rec["max_vs_rule"] = max(rec["max_vs_rule"], _err(a, b) / scale)
        q_fn = _quantiles((a.double() - w).abs() / scale)
        q_plain = _quantiles((p.double() - w).abs() / scale)
        q_vs = _quantiles((a - p).abs() / scale)
        rec[name] = dict(p99_vs_plain=q_vs[0], median_vs_plain=q_vs[1],
                         p99_vs_float64=q_fn[0], plain_p99_vs_float64=q_plain[0])
        check(bool(torch.isfinite(a).all()), f"K4 backward {name}: "
              f"non-finite")
        check(q_fn[0] <= max(K4_GRAD_P99, 2 * q_plain[0])
              and q_fn[1] <= max(K4_GRAD_MEDIAN, 2 * q_plain[1]),
              f"K4 backward {name}: {rec[name]}")
    check(rec["max_vs_rule"] <= 1e-6, f"K4 backward is not the rule on its "
          f"own outputs: {rec['max_vs_rule']:.3e}")
    log(f"K4 backward (hull main path's operands, {iters} iterations): "
        f"{json.dumps(rec)}")
    fwd_ms = time_ms(lambda: cuda_gjk.gjk_hull_obstacles(
        *(ops[k] for k in names), iters=iters), lead=True)
    bwd_ms = time_ms(lambda: torch.autograd.grad(
        outs, [args[k] for k in diff], cts, retain_graph=True), lead=True)
    L, M, _, B = ops["p0"].shape
    # reads R, t per (link, env), p0, p1, pa, pb, dist and the three
    # cotangents per pair; writes R̄, t̄ and p̄0, p̄1, r̄
    floats = L * B * (12 + 12) + L * M * B * (3 * 4 + 1 + 3 + 3 + 1 + 7)
    bwd_bound = bound_ms(4.0 * floats, 0.0)
    log(f"K4 backward at {L} x {M} x {B}: forward {fwd_ms:.4f} ms, "
        f"backward {bwd_ms:.4f} ms, bound {bwd_bound[0]:.5f} ms "
        f"({bwd_bound[1]})")
    return dict(rec, iters=iters, forward_ms=fwd_ms, backward_ms=bwd_ms,
                backward_bound_ms=bwd_bound[0], backward_bound_by=bwd_bound[1])


def grad_routes(device) -> dict:
    """On CUDA tensors that require grad: K2a (both layouts) and K2b return
    outputs with PullbackResolve's grad_fn, launching their kernel (their
    counters rise by one), and K5 raises; under torch.no_grad() K5 runs."""
    J, W, v = k2_rows(0, 256, device=device)
    J = _leaf(J)
    counts = {}
    for name, fn in (
            ("pullback_resolve", lambda: cuda_resolve.pullback_resolve(
                J, W, v)),
            ("pullback_resolve_t", lambda: cuda_resolve.pullback_resolve_t(
                J.permute(2, 1, 0), W.permute(2, 1, 0), v.permute(1, 0))),
            ("pullback_resolve_blocks",
             lambda: cuda_resolve.pullback_resolve_blocks([J], [W], [v]))):
        before = COUNTERS[name].launches
        out = fn()
        counts[name] = COUNTERS[name].launches - before
        check(type(out.grad_fn).__name__ == "PullbackResolveBackward"
              and counts[name] == 1, f"{name} under grad: grad_fn "
              f"{type(out.grad_fn).__name__}, {counts[name]} launches")
        torch.autograd.grad(out.sum(), J)
    env = envs.make(SCENE)
    fn = cuda_tick.make_fused_qdd(env)
    q, qd, goal, p0, p1, r = k5_inputs(env, 256, 5, wide=False)
    raised = False
    try:
        fn(_leaf(q), qd, goal, p0, p1, r)
    except RuntimeError as e:
        raised = "no derivative rule" in str(e)
    check(raised, "K5 did not raise under grad")
    with torch.no_grad():
        check(bool(torch.isfinite(fn(_leaf(q), qd, goal, p0, p1, r)).all()),
              "K5 under no_grad: non-finite")
    log(f"K2a/K2b under grad: {counts}; K5 raises under grad")
    return dict(k2_launches=counts, k5_raises=raised)


def _zero_counters() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0
    cuda_resolve.pullback_resolve_structured.transposed_launches = 0


def _read_counters() -> dict:
    out = {name: fn.launches for name, fn in COUNTERS.items()}
    out["pullback_resolve_structured (transposed)"] = (
        cuda_resolve.pullback_resolve_structured.transposed_launches)
    return out


@spent(by="device")
def grad_case(scene: str, geometry: str, method: str, fused: bool, B: int,
              ticks: int, device, float64: bool = False,
              plain: bool = False):
    """tune_gains' loss and gradient (in the log gains) on `scene` from its
    reset of B envs over `ticks` ticks, the batched rollout where `fused`:
    (loss, gradient, launches of the run). float64 runs the same problem
    in float64 through the plain versions; plain the plain versions in
    float32. K4 takes the envelope rule in every run."""
    env = envs.make(scene, device=device)
    env.resolve_method = method
    env.collision_geometry = geometry
    env.on_solved = None
    states = envs.make_batched_reset(env, B)()
    if float64:
        states = _as_dtype(states, torch.float64)
    loss, theta, _ = tune_gains.make_loss(env, B, ticks, fused_resolve=fused,
                                          states=states)
    theta = exp_common.leaves(theta)
    with (plain_kernels(float64=float64, grad=True) if plain or float64
          else contextlib.nullcontext()):
        if device.type == "cuda":
            torch.cuda.synchronize()
        _zero_counters()
        val, grads = exp_common.value_and_grad(loss, theta)
        if device.type == "cuda":
            torch.cuda.synchronize()
        launches = _read_counters()
    return (float(val), np.asarray([float(g) for g in grads.values()]),
            launches)


def phase_grad_rollouts(card: str, device) -> tuple[dict, dict]:
    """Each GRAD_SCENES case on the card with the kernels (counts zeroed
    before, read after), on the card with plain_kernels(), on the CPU and
    in float64 on the CPU: the card's loss and gradient against the CPU's
    (the float64 screen), the hull tiers also by JAX's kernel-vs-XLA
    measure against the CPU's."""
    cpu = torch.device("cpu")
    recs, paths = {}, {}
    for scene, geometry, method, fused, B, ticks in GRAD_SCENES:
        what = (f"tune_gains {scene} ({geometry}, '{method}', "
                f"{'batched' if fused else 'per-env'})")
        t0 = time.perf_counter()
        v_card, g_card, launches = grad_case(scene, geometry, method, fused,
                                             B, ticks, device)
        card_s = time.perf_counter() - t0
        v_plain, g_plain, _ = grad_case(scene, geometry, method, fused, B,
                                        ticks, device, plain=True)
        v_cpu, g_cpu, _ = cpu_run(grad_case, scene, geometry, method, fused,
                                  B, ticks, cpu)
        v64, g64, _ = cpu_run(grad_case, scene, geometry, method, fused, B,
                              ticks, cpu, float64=True)
        limit = max(GRAD_RTOL * np.linalg.norm(g_cpu),
                    GRAD_SPREAD * np.linalg.norm(g_cpu - g64))
        v_limit = max(1e-5 * max(1.0, abs(v_cpu)),
                      GRAD_SPREAD * abs(v_cpu - v64))
        rec = dict(loss=dict(card=v_card, plain=v_plain, cpu=v_cpu,
                             float64=v64),
                   grad=dict(card=g_card.tolist(), plain=g_plain.tolist(),
                             cpu=g_cpu.tolist(), float64=g64.tolist()),
                   limit=limit, loss_limit=v_limit, seconds_card=card_s,
                   launches=launches)
        log(f"{what}: {json.dumps(rec)}")
        for name, v, gr in (("card", v_card, g_card),
                            ("card, plain kernels", v_plain, g_plain)):
            check(np.all(np.isfinite(gr)) and np.isfinite(v),
                  f"{what}, {name}: non-finite")
            check(abs(v - v_cpu) <= v_limit, f"{what}, {name}: loss {v} vs "
                  f"CPU {v_cpu} (limit {v_limit:.3e})")
            check(np.linalg.norm(gr - g_cpu) <= limit,
                  f"{what}, {name}: gradient {gr} vs CPU {g_cpu} (limit "
                  f"{limit:.3e})")
            if geometry == "hull":
                cos = float(gr @ g_cpu / (np.linalg.norm(gr)
                                          * np.linalg.norm(g_cpu)))
                ratio = float(np.linalg.norm(gr) / np.linalg.norm(g_cpu))
                check(cos > HULL_COSINE and HULL_RATIO[0] < ratio
                      < HULL_RATIO[1], f"{what}, {name}: cosine {cos}, "
                      f"ratio {ratio}")
        want = {"fk_derivatives_batched": ticks}
        if fused and method == "solve":
            want["pullback_resolve_structured"] = ticks
            want["pullback_resolve_structured (transposed)"] = ticks
        if geometry == "hull":
            want["gjk_hull_obstacles"] = ticks
        for name, count in launches.items():
            check(count == want.get(name, 0), f"{what}: {name} launched "
                  f"{count} times, want {want.get(name, 0)}")
        recs[what] = rec
        paths[what] = launches
    return recs, paths


@spent()
def phase_remat(device) -> dict:
    """Remat on the card: tune_gains through the batched 'solve' rollout of
    franka/06 (K1, K3) and two_joint/01 with every env solved at tick 0
    (on_solved draws a new goal from EnvState.rng inside a recomputed
    tick), each with and without remat: the same loss, gradients within
    REMAT_RTOL, and the generator where the run without remat leaves it."""
    out = {}
    env = envs.make(SCENE)
    env.resolve_method = "solve"
    runs = []
    for remat in (False, True):
        loss, theta, _ = tune_gains.make_loss(env, GRAD_B, GRAD_TICKS,
                                              remat=remat, fused_resolve=True)
        val, grads = exp_common.value_and_grad(loss,
                                               exp_common.leaves(theta))
        runs.append((float(val), [float(g) for g in grads.values()]))
    (va, ga), (vb, gb) = runs
    check(abs(va - vb) <= 1e-6 * max(1.0, abs(va)), f"remat: loss {vb} vs "
          f"{va}")
    check(np.allclose(gb, ga, rtol=REMAT_RTOL, atol=0.0),
          f"remat: gradient {gb} vs {ga}")
    out[SCENE] = dict(loss=[va, vb], grad=[ga, gb])
    env = envs.make("two_joint/01_target_rmp_only")
    runs = []
    for remat in (False, True):
        states = envs.make_batched_reset(env, GRAD_B)()
        ee = envs.base.ee_position(env, states.sim)
        states = dataclasses.replace(states, sim=dataclasses.replace(
            states.sim, goal=ee.clone()))
        base = env.gather_params()
        log_a = torch.log(torch.tensor(float(base[0]["alpha"]),
                                       device=device)).requires_grad_()
        prm = dict(base[0], alpha=torch.exp(log_a))
        final, aux = envs.make_rollout(env, GRAD_TICKS, remat=remat)(
            states, (prm,) + tuple(base[1:]))
        check(bool(aux["resample"][:, 0].all()), "remat: no resample at "
              "tick 0")
        d = torch.linalg.vector_norm(aux["ee"][:, -1] - final.sim.goal,
                                     dim=-1).mean()
        (gr,) = torch.autograd.grad(d, log_a)
        runs.append((float(d.detach()), float(gr), final.sim.goal.detach(),
                     states.rng.get_state()))
    (da, ga, goal_a, rng_a), (db, gb, goal_b, rng_b) = runs
    check(abs(da - db) <= 1e-6 and abs(gb - ga) <= REMAT_RTOL * abs(ga),
          f"remat with a resample: {da, ga} vs {db, gb}")
    check(torch.equal(goal_a, goal_b) and torch.equal(rng_a, rng_b),
          "remat with a resample: goals or generator differ")
    out["two_joint/01 resample"] = dict(loss=[da, db], grad=[ga, gb],
                                        generator_equal=True)
    log(f"remat on the card: {json.dumps(out)}")
    return out


def timed_steps(step, n: int) -> list:
    """Host seconds of n calls of step(), each ending in a synchronize."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def step_trace(step) -> dict:
    """Device launches, busy ms and idle share of one traced step."""
    kernels = device_kernels(traced(step, host_ops=False))
    busy = _busy_us(kernels) / 1e3
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels)) / 1e3
    return dict(device_launches=len(kernels), device_busy_ms=busy,
                traced_span_ms=span)


@spent()
def reach_trainer(card: str, device, failed: list) -> tuple[dict, dict]:
    """train_neural_rmp on the card: its entry point at its defaults for two
    steps (--stop-after 2; the card is its default device); the time,
    launches, peak memory and trace of an optimizer step at the defaults
    (two-joint, hidden 32 x 32, batch 128, 50 ticks); then
    tests/test_neural.py's criterion from its own net and episodes
    (reach_descent_case.npz): 25 Adam steps at 3e-3 at batch 32 x 25
    ticks, the loss below 0.8 of its first value and the mean final
    distance improved."""
    t0 = time.perf_counter()
    train_neural_rmp.main(["--stop-after", "2"])
    entry_s = time.perf_counter() - t0
    gen = torch.Generator(device=device).manual_seed(0)
    env = reach_env.make_neural_env(device, gen=gen)
    d = REACH_DEFAULTS
    loss, _, _, base = train_neural_rmp.make_loss(env, d["batch"], d["ticks"])
    net = exp_common.leaves(base[0]["net"])
    trainer = exp_common.Trainer(net, d["lr"], d["steps"], d["clip"])
    count = [0]

    def step():
        _, grads = exp_common.value_and_grad(loss, net)
        trainer.update(grads, count[0])
        count[0] += 1
    step()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters()
    seconds = timed_steps(step, 3)
    launches = _read_counters()
    peak = torch.cuda.max_memory_allocated()
    trace = step_trace(step)
    step_ms = 1e3 * float(np.median(seconds))
    trace["device_idle_share"] = 1.0 - trace["device_busy_ms"] / step_ms
    check(launches["fk_derivatives_batched"] == 3 * d["ticks"],
          f"reach trainer: K3 launched {launches['fk_derivatives_batched']} "
          f"times in 3 steps")
    with np.load(train_neural_rmp_case()) as case:
        cnet = convert.net_from_numpy({k[4:]: case[k] for k in case.files
                                       if k.startswith("net_")}, device)
        states = convert.state_from_numpy(
            {k: case[k] for k in case.files if not k.startswith("net_")},
            device)
    cenv = reach_env.make_neural_env(device, net=cnet)
    closs, cmetrics, _, cbase = train_neural_rmp.make_loss(
        cenv, DESCENT["batch"], DESCENT["ticks"], states=states)
    cnet = exp_common.leaves(cbase[0]["net"])
    with torch.no_grad():
        m0 = float(cmetrics(cnet)[1]["mean_final_dist"])
    opt = torch.optim.Adam(list(cnet.values()), lr=DESCENT["lr"])
    v_first = None
    for _ in range(DESCENT["steps"]):
        v, grads = exp_common.value_and_grad(closs, cnet)
        v_first = float(v) if v_first is None else v_first
        for k, p in cnet.items():
            p.grad = grads[k]
        opt.step()
    with torch.no_grad():
        v_last = float(closs(cnet))
        m1 = float(cmetrics(cnet)[1]["mean_final_dist"])
    criterion = dict(v_first=v_first, v_last=v_last, ratio=v_last / v_first,
                     mean_final_dist=[m0, m1])
    rec = dict(entry_point_s=entry_s, step_ms=step_ms,
               step_ms_all=[1e3 * s for s in seconds],
               launches_per_step={k: c / 3 for k, c in launches.items()},
               peak_memory_bytes=peak, trace=trace, criterion=criterion,
               defaults=d)
    log(f"train_neural_rmp at its defaults [{card}]: {json.dumps(rec)}")
    if not (v_last < 0.8 * v_first and m1 < m0):
        failed.append(f"train_neural_rmp: tests/test_neural.py's criterion "
                      f"{criterion}")
    return launches, rec


def train_neural_rmp_case() -> str:
    return os.path.join(os.path.dirname(train_neural_rmp.__file__),
                        "reach_descent_case.npz")


@spent()
def clutter_trainer(card: str, device, failed: list) -> tuple[dict, dict]:
    """train_neural_clutter on the card: its entry point at its defaults
    (batch 1024, 100 ticks, remat, hidden 32 x 32) for one step
    (--stop-after 1), its per-env clipped gradient timed from the inside
    (the module function the entry point calls, wrapped: host seconds,
    launches, the envs dropped, peak memory); then one step of 1024 envs
    over CLUTTER_NO_REMAT_TICKS ticks without remat, for its time and peak
    memory."""
    d = CLUTTER_DEFAULTS
    vg = train_neural_clutter.per_env_value_and_grad
    calls = []

    def timed_vg(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counters()
        t0 = time.perf_counter()
        out = vg(*args, **kwargs)
        torch.cuda.synchronize()
        calls.append(dict(seconds=time.perf_counter() - t0,
                          launches=_read_counters(),
                          peak_memory_bytes=torch.cuda.max_memory_allocated(),
                          loss=float(out[0]), gnorm=float(out[2]),
                          dropped_share=float(out[3])))
        return out
    train_neural_clutter.per_env_value_and_grad = timed_vg
    t0 = time.perf_counter()
    try:
        train_neural_clutter.main(["--stop-after", "1"])
    finally:
        train_neural_clutter.per_env_value_and_grad = vg
    entry_s = time.perf_counter() - t0
    check(len(calls) == 1, f"clutter trainer: {len(calls)} gradient calls")
    entry = calls[0]
    launches = entry["launches"]
    log(f"train_neural_clutter entry point, one step at its defaults "
        f"[{card}]: {entry_s:.1f} s in all; the step: {json.dumps(entry)}")
    if not (np.isfinite(entry["loss"]) and np.isfinite(entry["gnorm"])):
        failed.append(f"train_neural_clutter: non-finite {entry}")
    gen = torch.Generator(device=device).manual_seed(0)
    net0 = neural.transparent_obstacle_init(neural.mlp_init(
        gen, (neural.OBSTACLE_FEATURES, *d["hidden"], 2)))
    env = clutter_env.make_neural_clutter_env(device, net=net0, train=True)
    states = envs.make_batched_reset(env, d["batch"], 0)()
    base = env.gather_params()
    slot = len(base) - 1
    weights = dict(clear_margin=0.05, pen_margin=0.005, w_collision=10.0,
                   w_pen=300.0, w_effort=1e-4)
    net = exp_common.leaves(base[slot]["net"])
    trainer = exp_common.Trainer(net, d["lr"], d["steps"], d["clip"])
    rollout = envs.make_rollout(env, CLUTTER_NO_REMAT_TICKS, remat=False)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters()
    t0 = time.perf_counter()
    val, grad, gnorm, dropped = vg(rollout, base, slot, net, states,
                                   weights, d["env_clip"])
    trainer.update(grad, 0)
    torch.cuda.synchronize()
    plain = dict(ticks=CLUTTER_NO_REMAT_TICKS,
                 seconds=time.perf_counter() - t0, launches=_read_counters(),
                 peak_memory_bytes=torch.cuda.max_memory_allocated(),
                 loss=float(val), gnorm=float(gnorm),
                 dropped_share=float(dropped))
    log(f"train_neural_clutter step without remat [{card}]: "
        f"{json.dumps(plain)}")
    if not (np.isfinite(plain["loss"]) and np.isfinite(plain["gnorm"])):
        failed.append(f"train_neural_clutter: non-finite {plain}")
    # K3 1 + 8 times a forward tick (the detour IK), again in the remat
    # recomputation
    want = 2 * d["ticks"] * 9
    check(launches["fk_derivatives_batched"] == want, f"clutter trainer: "
          f"K3 launched {launches['fk_derivatives_batched']} times, want "
          f"{want}")
    return launches, dict(remat=entry, no_remat=plain, entry_point_s=entry_s,
                          defaults=d)


@spent()
def tune_gains_hull(card: str) -> tuple[dict, dict]:
    """tune_gains' entry point on the card in the hull tier of franka/06
    (its default batch of 16: every pair cold through K4), 3 steps of
    TUNE_TICKS ticks."""
    torch.cuda.synchronize()
    _zero_counters()
    t0 = time.perf_counter()
    tuned = tune_gains.main(["--env", SCENE, "--geometry", "hull",
                             "--steps", "3", "--ticks", str(TUNE_TICKS)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _read_counters()
    rec = dict(seconds=seconds, tuned=tuned, launches=launches)
    log(f"tune_gains --geometry hull [{card}]: {json.dumps(rec)}")
    check(all(np.isfinite(v) for v in tuned.values()), "tune_gains: "
          "non-finite gains")
    for name in ("fk_derivatives_batched", "gjk_hull_obstacles"):
        check(launches[name] > 0, f"tune_gains hull: {name} not launched")
    return launches, rec


def phase_slice11(card: str, device) -> dict:
    """Phase 17: the backward of K1, K3 and K4 at B = 4096; tune_gains'
    gradients through rollouts on the card, with plain kernels and on the
    CPU; remat on the card; the three trainers at full width. Every part
    runs before the trainers' criteria are checked."""
    times = {}
    t0 = time.perf_counter()
    k1 = k1_backward(device)
    k3 = {"panda": k3_backward(robots.franka_panda(), "Panda", device),
          "dual_panda": k3_backward(robots.dual_panda(), "dual Panda",
                                    device)}
    k4 = k4_backward(device)
    routes = grad_routes(device)
    times["backward"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rollouts, paths = phase_grad_rollouts(card, device)
    times["rollouts"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    remat = phase_remat(device)
    times["remat"] = time.perf_counter() - t0
    failed: list = []
    t0 = time.perf_counter()
    launches, reach = reach_trainer(card, device, failed)
    paths["train_neural_rmp (3 steps)"] = launches
    times["train_neural_rmp"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches, clutter = clutter_trainer(card, device, failed)
    paths["train_neural_clutter (1 step)"] = launches
    times["train_neural_clutter"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches, hull = tune_gains_hull(card)
    paths["tune_gains --geometry hull (3 steps)"] = launches
    times["tune_gains_hull"] = time.perf_counter() - t0
    log(f"phase 17 parts (s): {json.dumps(times)}")
    check(not failed, "; ".join(failed))
    return dict(k1=k1, k3=k3, k4=k4, routes=routes, rollouts=rollouts,
                remat=remat,
                reach=reach, clutter=clutter, tune_gains_hull=hull,
                paths=paths, seconds=times)

# ------------------------------------------- phase 18: the twelfth slice ---

PLANAR_LINKS = (5, 12)     # the N-link arms of the generality path
PLANAR_TICKS = PATH_TICKS
FINE_TICKS = 30            # the fine-capsule flagship (~1.9x the pairs)
BF16_CONTRACT = 1e-2       # tests/test_pallas_resolve.py's bf16 bound on q
# K1's layout at every n (random blocks): the flagship's shape with a
# shorter obstacle block
K1_EVERY_N_LAYOUT = (("dense", 3), ("identity", 0), ("identity", 0),
                     ("scalar", 20))
K1_TIMED_N = (5, 12, 18, 32)
# phase 18's sweep: the lane and warp kernels' n, by name (the CTA kernel's
# n = 33..64 are phase 23's)
K1_EVERY_N = range(1, 33)
K1_BLOCKS20 = ((("identity", 0),) * 3 + (("dense", 3),) * 9
               + (("scalar", 7),) * 8)


def k1_device_blocks(seed: int, B: int, n: int, layout, device):
    """k1_layout_blocks' distributions drawn on the card (a seeded
    torch.Generator): the every-n sweep draws 64 layouts."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=device)

    def spd(d):
        L = rand(B, d, d) * 0.3
        return L @ L.transpose(1, 2) + 0.5 * torch.eye(d, device=device)

    blocks = []
    for tag, R in layout:
        if tag == "identity":
            blocks.append((spd(n), rand(B, n)))
        elif tag == "dense":
            J = rand(B, R, n)
            blocks.append((J, spd(R) @ J, rand(B, R)))
        else:
            m = 2.0 * torch.rand(B, R, generator=g, device=device)
            blocks.append((rand(B, R, n) * 0.3, m, rand(B, R)))
    return tuple(tag for tag, _ in layout), blocks


def k1_raises(tags, blocks, what: str) -> str:
    """K1's wrapper must raise ValueError before any launch."""
    before = cuda_resolve.pullback_resolve_structured.launches
    try:
        cuda_resolve.pullback_resolve_structured(tags, blocks)
        raised = None
    except ValueError as e:
        raised = str(e)
    check(raised is not None and before ==
          cuda_resolve.pullback_resolve_structured.launches,
          f"K1 {what}: no ValueError before a launch")
    log(f"K1 {what} raises: {raised}")
    return raised


def k1_times(what: str, tags, blocks, block_dtype=None) -> dict:
    """K1 on the blocks timed as phase 3 times it (the wrapper from an idle
    stream, the device alone with the stream kept busy), its plain version,
    einsum + torch.linalg.solve on the same system (upcast), and its bound
    from these inputs."""
    def call():
        return cuda_resolve.pullback_resolve_structured(
            tags, blocks, block_dtype=block_dtype)
    up = [tuple(x.float() for x in blk) for blk in blocks]
    rec = dict(ms=time_ms(call), device_ms=time_ms(call, lead=True),
               plain_ms=time_ms(lambda: cuda_resolve.
                                pullback_resolve_structured_plain(
                                    tags, blocks, block_dtype=block_dtype),
                                reps=5),
               library_ms=time_ms(lambda: k1_library(tags, up)))
    rec["bound_ms"], rec["bound_by"] = k1_bound(*(
        cuda_resolve.cast_blocks(tags, blocks, block_dtype)
        if block_dtype is not None else (tags, blocks)))
    log(f"K1 {what} times at B={blocks[0][0].shape[0]}: wrapper "
        f"{rec['ms']:.4f} ms (device alone {rec['device_ms']:.4f} ms), "
        f"plain {rec['plain_ms']:.4f} ms, einsum+linalg.solve "
        f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.6f} ms "
        f"({rec['bound_by']})")
    return rec


def phase_k1_every_n(env, device) -> tuple[dict, float]:
    """K1 against its plain version at every n of K1_EVERY_N (1 to 32: the
    lane and warp kernels), on float32 and on bfloat16 blocks, at B =
    BATCH; a 20-block layout; 33 blocks raising before a launch (n = 65,
    past the CTA kernel, raises in phase 23); the lane and warp kernels'
    build lines; times at K1_TIMED_N and on the flagship's real tick in
    bfloat16."""
    build = dict(lane=ptxas_counts("pullback_resolve.cu",
                                   "pullback_resolve_kernel"),
                 wide=ptxas_counts(K1_WIDE_SOURCE,
                                   "pullback_resolve_wide_kernelILi18E"))
    log(f"K1 builds over every n (largest): {json.dumps(build)}")
    err, errs = 0.0, {}
    for n in K1_EVERY_N:
        errs[n] = []
        # the warp kernel (n > 9) also at the batches that fill no CTA
        for B in (BATCH,) + (RAGGED if n > K1_LANE_N else ()):
            tags, blocks = k1_device_blocks(n if B == BATCH else n + B, B, n,
                                            K1_EVERY_N_LAYOUT, device)
            half = [tuple(x.to(torch.bfloat16) for x in blk)
                    for blk in blocks]
            errs[n] += [k1_compare(tags, blocks, f"n={n}, float32, B={B}"),
                        k1_compare(tags, half,
                                   f"n={n}, bfloat16 blocks, B={B}")]
        err = max(err, *errs[n])
    tags, blocks = k1_device_blocks(20, BATCH, 9, K1_BLOCKS20, device)
    err = max(err, k1_compare(tags, blocks, "20 blocks, n=9"))
    k1_raises(*k1_device_blocks(34, 4, 3, (("dense", 2),) * 33, device),
              "33 blocks")
    times = {}
    for n in K1_TIMED_N:
        tags, blocks = k1_device_blocks(n, BATCH, n, K1_EVERY_N_LAYOUT,
                                        device)
        times[f"n={n}"] = k1_times(f"n={n} (random layout)", tags, blocks)
    rtags, rblocks = real_tick_blocks(env, BATCH, 1)
    half = cuda_resolve.cast_blocks(rtags, rblocks, torch.bfloat16)
    err = max(err, k1_compare(*half, "flagship real tick, bfloat16 blocks"))
    got = cuda_resolve.pullback_resolve_structured(
        rtags, rblocks, block_dtype=torch.bfloat16)
    want = cuda_resolve.pullback_resolve_structured_plain(
        rtags, rblocks, block_dtype=torch.bfloat16)
    f32 = cuda_resolve.pullback_resolve_structured_plain(rtags, rblocks)
    torch.cuda.synchronize()
    check(torch.equal(got, cuda_resolve.pullback_resolve_structured(*half)),
          "K1 block_dtype: not the kernel on the cast blocks")
    rel = float(((want - f32).abs().amax(dim=1)
                 / f32.abs().amax(dim=1).clamp_min(1.0)).max())
    log(f"K1 flagship bf16 against float32 (plain): max rel {rel:.3e}")
    per_call = device_launches(lambda: cuda_resolve.
                               pullback_resolve_structured(*half),
                               "pullback_resolve_kernel", "K1 bf16")
    check(per_call == 1, "K1 bf16: not one launch per wrapper call")
    times["flagship bf16"] = dict(k1_times("flagship bf16 (cast blocks)",
                                           *half),
                                  device_launches_per_call=per_call,
                                  block_dtype_call=k1_times(
                                      "flagship, block_dtype=bfloat16 "
                                      "(casts included)", rtags, rblocks,
                                      torch.bfloat16),
                                  rel_to_float32=rel)
    times["flagship f32"] = k1_times("flagship float32 (again)", rtags,
                                     rblocks)
    return dict(build=build, errors={str(k): v for k, v in errs.items()},
                times=times), err


def planar_inputs(env, B: int, seed: int):
    """K5's inputs near the planar env's reset: q ± 0.1, q̇ ± 0.05, goal ±
    0.05, its cylinder per env."""
    states = perturbed_states(env, B, seed, 0.1, 0.05)
    rng = np.random.default_rng(seed + 1)
    goal = states.sim.goal + torch.tensor(
        rng.uniform(-0.05, 0.05, (B, 3)), dtype=torch.float32,
        device=states.sim.q.device)
    obs = states.sim.obstacles
    return (states.sim.q, states.sim.qd, goal, obs.p0.contiguous(),
            obs.p1.contiguous(), obs.radius.contiguous())


def phase_producers_and_k5(device) -> tuple[dict, float, float, float]:
    """K2a and K2b fed by core.policy_rows / policy_row_blocks on the
    five-link env at BATCH envs against their plain versions and the
    structured K1's q̈; K5 at n = 5 and 12 against its plain version and
    the env's own batched step, timed beside its bound."""
    env = planar.planar_arm_env(5)
    states = perturbed_states(env, BATCH, 6, 0.1, 0.05)
    q, qd, prm, ctxs, fk = _policy_inputs(env, states, env.gather_params())
    Js, Ws, vs = core.policy_row_blocks(env.policies, q, qd, prm, ctxs,
                                        fk=fk)
    J, W, v = core.policy_rows(env.policies, q, qd, prm, ctxs, fk=fk)
    tags, blocks = policy_row_blocks_structured(env.policies, q, qd, prm,
                                                ctxs, fk=fk)
    k1 = cuda_resolve.pullback_resolve_structured(tags, blocks)
    log(f"producers on planar_5link: {len(Js)} blocks of rows "
        f"{[x.shape[1] for x in Js]}, {J.shape[1]} rows in all")
    err_a = k2_compare(cuda_resolve.pullback_resolve(J, W, v),
                       cuda_resolve.pullback_resolve_plain(J, W, v),
                       "K2a from core.policy_rows, planar_5link")
    err_b = k2_compare(cuda_resolve.pullback_resolve_blocks(Js, Ws, vs),
                       cuda_resolve.pullback_resolve_blocks_plain(Js, Ws, vs),
                       "K2b from core.policy_row_blocks, planar_5link")
    k2_compare(cuda_resolve.pullback_resolve_blocks(Js, Ws, vs), k1,
               "K2b from the dense producer against K1 on the structured "
               "blocks")
    k5, err5 = {}, 0.0
    for n_links in PLANAR_LINKS:
        env = planar.planar_arm_env(n_links)
        tick = cuda_tick.fused_tick(env)
        fn = cuda_tick.make_fused_qdd(env)
        args = planar_inputs(env, BATCH, 11)
        plain = functools.partial(cuda_tick.fused_qdd_plain, tick)
        got, want = fn(*args), plain(*args)
        start = envs.make_batched_reset(env, BATCH)()
        states = dataclasses.replace(start, sim=dataclasses.replace(
            start.sim, q=args[0], qd=args[1], goal=args[2],
            obstacles=collision.ObstacleSet(*args[3:],
                                            kinds=("cylinder",))))
        _, aux = make_batched_control_step(env)(states, env.gather_params())
        # links that pierce the cylinder (q ± 0.1 from the reset, 0.22 m
        # clear) make the 1/d curvature row amplify rounding: the envs
        # compared are phase 11's wide screen's (finite, moved by at most
        # STABLE under a one-ulp move of q and q̇, plain within K5_ACCURATE
        # of float64), the rest counted and their worst printed
        up = torch.tensor(float("inf"), device=device)
        ulp = plain(torch.nextafter(args[0], up),
                    torch.nextafter(args[1], up), *args[2:])
        f64 = plain(*(x.double() for x in args))
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K5 n={n_links}: non-finite")
        held = (torch.isfinite(want).all(dim=1)
                & (k5_rel(ulp, want) <= STABLE)
                & (k5_rel(f64, want.double()) <= K5_ACCURATE))
        n_held = int(held.sum())
        rel = k5_rel(got, want)
        worst = int(rel.argmax())
        log(f"K5 planar_{n_links}link: {n_held} of {BATCH} envs compared; "
            f"over all {float(rel.max()):.3e} at env {worst} (one-ulp move "
            f"{float(k5_rel(ulp, want)[worst]):.1e}, plain vs float64 "
            f"{float(k5_rel(f64, want.double())[worst]):.1e}, kernel vs "
            f"float64 {float(k5_rel(got.double(), f64)[worst]):.1e})")
        check(n_held >= BATCH // 2, f"K5 n={n_links}: too few envs compared")
        err5 = max(err5, k5_check(f"planar_{n_links}link, kernel vs plain",
                                  rel[held], K1_TOL))
        k5_check(f"planar_{n_links}link, kernel vs the batched step's q̈",
                 k5_rel(got, aux["qdd"])[held], K1_TOL)
        smem = _build.c_function("rmp_fused_qdd_shared_bytes",
                                 [ctypes.c_int] * 3)(
            tick.model.n_frames, n_links, len(tick.col_frames))
        per_call = device_launches(lambda: fn(*args), "fused_qdd_kernel",
                                   f"K5 n={n_links}")
        check(per_call == 1, "K5: not one launch per wrapper call")
        b_ms, b_by = k5_bound(tick, BATCH, 1)
        rec = dict(ms=time_ms(lambda: fn(*args)),
                   device_ms=time_ms(lambda: fn(*args), lead=True),
                   plain_ms=time_ms(lambda: cuda_tick.fused_qdd_plain(
                       tick, *args), reps=5),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None,
                   device_launches_per_call=per_call,
                   dynamic_smem_bytes=smem,
                   build=ptxas_counts("fused_tick.cuh",
                                      f"fused_qdd_kernelILi{n_links}E"))
        log(f"K5 planar_{n_links}link times at B={BATCH}: kernel "
            f"{rec['ms']:.4f} ms (device alone {rec['device_ms']:.4f} ms), "
            f"plain {rec['plain_ms']:.4f} ms, bound {b_ms:.6f} ms ({b_by}); "
            f"{smem} B of shared memory, build {json.dumps(rec['build'])}")
        k5[f"planar_{n_links}link"] = rec
    return k5, err_a, err_b, err5


def _ee_goal_distance(env, states) -> torch.Tensor:
    ee = kinematics.fk_position(env.model, states.sim.q, env.ee_frame)
    return (ee - states.sim.goal).norm(dim=-1)


@spent()
def rollout_path(card: str, env, what: str, ticks: int,
                 path_kernels: tuple, failed: list) -> tuple[dict, dict]:
    """`env` at BATCH envs x `ticks` from its reset after WARMUP_TICKS,
    timed, every counter zeroed just before and read after (the
    path_kernels once per tick, every other 0); one tick under the sync
    debug mode after the warm-up (the first tick builds the model's device
    tables); every q finite; the median EE distance to the goal before and
    after; a 10-tick trace."""
    params = env.gather_params()
    states = envs.make_batched_reset(env, BATCH)()
    before = float(_ee_goal_distance(env, states).median())
    states, _ = envs.make_batched_rollout(env, WARMUP_TICKS,
                                          with_aux=False)(states, params)
    syncs = sync_free_tick(env, states, params, what)
    if syncs:
        failed.append(f"{what}: the tick synchronizes with the device")
    rollout = envs.make_batched_rollout(env, ticks, with_aux=False)
    torch.cuda.synchronize()
    _zero_counters()
    t0 = time.perf_counter()
    final, _ = rollout(states, params)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    steps_per_s = BATCH * ticks / seconds
    after = float(_ee_goal_distance(env, final).median())
    log(f"{what}: {BATCH} envs x {ticks} ticks in {seconds:.3f} s = "
        f"{steps_per_s:.1f} control steps/s [{card}]; median EE-goal "
        f"distance {before:.4f} m at reset, {after:.4f} m after")
    log(f"{what} launches: {launches}")
    for name, count in launches.items():
        want = ticks if name in path_kernels else 0
        check(count == want, f"{what}: {name} launched {count} times in "
              f"{ticks} ticks, want {want}")
    check(bool(torch.isfinite(final.sim.q).all()), f"{what}: non-finite q")
    trace = profile_ticks(env, final, params, seconds * 1e3 / ticks)
    log(f"{what} trace: {json.dumps(trace)}")
    return launches, dict(envs=BATCH, ticks=ticks, seconds=seconds,
                          control_steps_per_s=steps_per_s,
                          sync_calls_per_tick=len(syncs),
                          median_ee_goal_m=dict(reset=before, final=after),
                          trace=trace)


@spent()
def gpu_cpu_parity(make_env, what: str, B: int = 128, ticks: int = 5,
                   ulp: bool = False) -> dict:
    """q after `ticks` of the env on the card and on the CPU from the same
    perturbed reset (q ± 0.1, q̇ ± 0.05), held to PARITY_ATOL on the envs
    whose CPU run lies within STABLE of a float64 run of the same problem
    (witness_q's screen: the planar arms pierce their cylinder from these
    states, and the twelve-link arm's float32 runs part there), and with
    `ulp` also within STABLE of a CPU run from the start moved by one ulp,
    at least half of them; the GPU also within PARITY_ATOL of float64
    there."""
    q = {}
    for dev in ("cuda", "cpu") + (("ulp",) if ulp else ()):
        env = make_env("cpu" if dev == "ulp" else dev)
        final, _ = envs.make_batched_rollout(env, ticks, with_aux=False)(
            perturbed_states(env, B, 4, 0.1, 0.05, ulp=dev == "ulp"),
            env.gather_params())
        q[dev] = final.sim.q.cpu()
    env = make_env("cpu")
    states = _as_dtype(perturbed_states(env, B, 4, 0.1, 0.05), torch.float64)
    params = tuple(_as_dtype(p, torch.float64) for p in env.gather_params())
    with plain_kernels(float64=True):
        final, _ = envs.make_batched_rollout(env, ticks, with_aux=False)(
            states, params)
    exact = final.sim.q
    check(exact.dtype == torch.float64, f"{what}: the witness's dtype")
    rounding = (q["cpu"].double() - exact).abs().amax(dim=1)
    gap = (q["cuda"] - q["cpu"]).abs().amax(dim=1)
    keep = rounding <= STABLE
    if ulp:
        keep &= (q["ulp"] - q["cpu"]).abs().amax(dim=1) <= STABLE
    rec = dict(envs_compared=int(keep.sum()), max_abs_q=float(gap[keep].max()),
               max_abs_q_all=float(gap.max()),
               max_cpu_vs_float64=float(rounding.max()),
               max_gpu_vs_float64=float((q["cuda"].double() - exact).abs()
                                        .amax(dim=1)[keep].max()))
    log(f"{what} GPU/CPU parity ({B} envs x {ticks} ticks): {json.dumps(rec)} "
        f"(atol {PARITY_ATOL} on the envs compared)")
    check(rec["envs_compared"] >= B // 2, f"{what}: too few envs compared")
    check(rec["max_abs_q"] < PARITY_ATOL, f"{what}: GPU/CPU parity")
    check(rec["max_gpu_vs_float64"] < PARITY_ATOL,
          f"{what}: GPU against float64")
    return rec


def flagship(dev, dtype: str | None = None):
    env = envs.make(SCENE, device=dev)
    env.resolve_method = "solve"
    env.fused_blocks_dtype = dtype
    return env


def bf16_contract(device) -> dict:
    """JAX's bf16 contract on the card (tests/test_pallas_resolve.py): 128
    reset envs x 2 ticks, bf16 within 1e-2 of float32, finite, not
    identical."""
    q = {}
    for dtype in (None, "bf16"):
        env = flagship(device, dtype)
        final, _ = envs.make_batched_rollout(env, 2, with_aux=False)(
            envs.make_batched_reset(env, 128)(), env.gather_params())
        q[dtype] = final.sim.q
    gap = float((q["bf16"] - q[None]).abs().max())
    log(f"bf16 contract on the card: max|Δq| after 2 ticks {gap:.3e} (limit "
        f"{BF16_CONTRACT}, above 0)")
    check(bool(torch.isfinite(q["bf16"]).all()), "bf16 contract: non-finite")
    check(0.0 < gap <= BF16_CONTRACT, f"bf16 contract: {gap:.3e}")
    return dict(max_abs_q=gap)


def k1_us_per_tick(path: dict) -> float:
    return sum(v for k, v in path["trace"]["port_kernels_us_per_tick"].items()
               if "pullback_resolve" in k)


@contextlib.contextmanager
def fine_capsules():
    """RMP_PANDA_CAPS=fine while the block runs."""
    old = os.environ.get("RMP_PANDA_CAPS")
    os.environ["RMP_PANDA_CAPS"] = "fine"
    try:
        yield
    finally:
        if old is None:
            del os.environ["RMP_PANDA_CAPS"]
        else:
            os.environ["RMP_PANDA_CAPS"] = old


def phase_slice12(card: str, device) -> dict:
    """Phase 18: K1 at every n and in bfloat16, K2a/K2b from the dense
    producers, K5 at n = 5 and 12, the N-link envs at full batch with
    GPU/CPU parity, the flagship with bf16 blocks against float32 and JAX's
    bf16 contract, the fine-capsule flagship."""
    t_start = time.perf_counter()
    failed: list = []
    env = envs.make(SCENE)
    k1, k1_err = phase_k1_every_n(env, device)
    k5, k2a_err, k2b_err, k5_err = phase_producers_and_k5(device)
    paths, results = {}, {}
    k13 = ("pullback_resolve_structured", "fk_derivatives_batched")
    for n_links in PLANAR_LINKS:
        name = f"planar_{n_links}link"
        launches, res = rollout_path(
            card, planar.planar_arm_env(n_links), name, PLANAR_TICKS, k13,
            failed)
        res["parity"] = gpu_cpu_parity(
            lambda dev: planar.planar_arm_env(n_links, dev), name)
        paths[name], results[name] = launches, res
    for dtype, name in ((None, f"{SCENE} float32"),
                        ("bf16", f"{SCENE} bf16")):
        paths[name], results[name] = rollout_path(
            card, flagship(device, dtype), name, PATH_TICKS, k13, failed)
    contract = bf16_contract(device)
    log(f"flagship steps/s: float32 "
        f"{results[f'{SCENE} float32']['control_steps_per_s']:.1f}, bf16 "
        f"{results[f'{SCENE} bf16']['control_steps_per_s']:.1f}; K1 device us "
        f"per tick {k1_us_per_tick(results[f'{SCENE} float32']):.2f} / "
        f"{k1_us_per_tick(results[f'{SCENE} bf16']):.2f} [{card}]")
    with fine_capsules():
        name = f"{SCENE} fine capsules"
        fine_env = flagship(device)
        n_caps = sum(len(c) for c in fine_env.model.collision)
        check(n_caps == 47, f"fine capsules: {n_caps} primitives")
        paths[name], results[name] = rollout_path(card, fine_env, name,
                                                  FINE_TICKS, k13, failed)
        results[name]["parity"] = gpu_cpu_parity(flagship, name)
    check(sum(len(c) for c in flagship(device).model.collision) == 25,
          "the 25-capsule model after RMP_PANDA_CAPS is unset")
    seconds = time.perf_counter() - t_start
    log(f"phase 18: {seconds:.1f} s")
    check(not failed, "; ".join(failed))
    return dict(k1=k1, k1_err=k1_err, k2a_err=k2a_err, k2b_err=k2b_err,
                k5=k5, k5_err=k5_err, results=results,
                paths={k: (v, results[k]) for k, v in paths.items()},
                bf16_contract=contract, seconds=seconds)


# ------------------------------------------------ the thirteenth slice ----

WIDE_LINKS = (24, 32)         # the N-link arms past K3's narrow tile
# K3's earlier times on an H100 80GB HBM3 at 700 W (PERF.md), device alone
# at B = 4096, before the wide instantiation: the narrow one must keep them
K3_EARLIER_MS = {"panda": 0.0268, "dual_panda": 0.0824}
# each K3 kernel's source and mangled name
K3_INSTANTIATIONS = {
    "narrow": ("fk_derivatives.cu", "fk_derivatives_kernelILi32ELi18ELi8E"),
    "wide": ("fk_derivatives_wide.cu",
             "fk_derivatives_kernel_wideILi40ELi32ELi4E")}
SHARDED_TICKS = 20            # the sharded flagship at world size 1
LATENCY_BATCHES = (1, 64, 4096)
LATENCY_TICKS = 25     # 50 before the fifteenth slice
# 1000, 500 before the fourteenth slice, 500, 250 before the fifteenth
SOAK_TICKS, SOAK_CHUNK = 250, 125


def fixed_tail_model(n_links: int, extra: int, radius: float = 0.0):
    """The n_links planar arm with `extra` fixed links chained after its
    EE: n_links + 1 + extra frames, n_links motors; with a radius each
    tail link carries a sphere, a collision frame of its own."""
    spec = specs.make_planar_arm_spec(n_links)
    links, joints, parent = list(spec.links), list(spec.joints), "ee"
    for k in range(extra):
        collision = (specs.CollisionPrimitive(
            "sphere", (0, 0, 0), (0, 0, 0), radius),) if radius else ()
        links.append(specs.LinkSpec(f"tail_{k}", 0.01, (0, 0, 0),
                                    (1e-6,) * 3 + (0.0,) * 3, collision))
        joints.append(specs.JointSpec(f"tail_joint_{k}", "fixed", parent,
                                      f"tail_{k}", xyz=(0.01, 0, 0)))
        parent = f"tail_{k}"
    return specs.build_model(dataclasses.replace(
        spec, name=f"{spec.name}_tail{extra}", links=tuple(links),
        joints=tuple(joints)))


def branched_model(n_links: int = 20, n_branch: int = 8, at: int = 10):
    """The n_links planar arm with a branch of n_branch revolute links off
    link `at` (about y and z in turn, the first tilted) and a fixed tip:
    n_links + n_branch motors, n_links + n_branch + 2 frames. The frames
    are in BFS order, so past the branch the two chains interleave and a
    frame's parent is not the frame before it."""
    spec = specs.make_planar_arm_spec(n_links)
    links, joints, parent = list(spec.links), list(spec.joints), f"link_{at}"
    for k in range(n_branch):
        links.append(specs.LinkSpec(f"branch_{k + 1}", 0.2))
        joints.append(specs.JointSpec(
            f"branch_joint_{k + 1}", "revolute", parent, f"branch_{k + 1}",
            xyz=(0.25, 0.0, 0.1) if k == 0 else (0.3, 0.0, 0.0),
            rpy=(0.3, 0.0, 0.2) if k == 0 else (0.0, 0.0, 0.0),
            axis=(0, 1, 0) if k % 2 == 0 else (0, 0, 1), lower=-np.pi,
            upper=np.pi, velocity=5, effort=50))
        parent = f"branch_{k + 1}"
    links.append(specs.LinkSpec("branch_tip", 0.05))
    joints.append(specs.JointSpec("branch_tip_joint", "fixed", parent,
                                  "branch_tip", xyz=(0.3, 0.0, 0.0)))
    return specs.build_model(dataclasses.replace(
        spec, name=f"{spec.name}_branch{n_branch}", links=tuple(links),
        joints=tuple(joints)))


def k3_wide_models() -> dict:
    """K3's models past the narrow tile: the 24- and 32-link arms of the
    path, two odd n, the wide tile's capacity (40 frames, 32 motors) and a
    branched tree (frames whose parent is not the frame before)."""
    return {"planar_24 (F=25, n=24)": planar_model(24),
            "planar_32 (F=33, n=32)": planar_model(32),
            "planar_19 (F=20, n=19)": planar_model(19),
            "planar_31 (F=32, n=31)": planar_model(31),
            "planar_32 + 7 fixed (F=40, n=32)": fixed_tail_model(32, 7),
            "branched 20 + 8 (F=30, n=28)": branched_model()}


def planar_model(n_links: int):
    return specs.build_model(specs.make_planar_arm_spec(n_links))


def k3_check(model, what: str, device) -> float:
    """K3 against its plain version on `model` at B = BATCH and RAGGED,
    each output within K3_ATOL x max(1, max |plain|): along a long arm at
    q̇ up to 1 rad/s per joint, Td and c reach hundreds, and their float32
    rounding grows with them (the kernel's and the plain version's gaps to
    a float64 plain run are printed beside it). Returns the largest
    |kernel - plain| over the outputs."""
    err = 0.0
    for B in (BATCH,) + RAGGED:
        q, qd = k3_inputs(model, B, device)
        got = cuda_fk.fk_derivatives_batched(model, q, qd)
        want = fk_derivatives(model, q, qd)
        exact = fk_derivatives(model, q.double(), qd.double())
        torch.cuda.synchronize()
        worst, scale, rounding = {}, {}, {}
        for name, g, w, x in zip(("T16", "Td16", "J16", "c16"), got, want,
                                 exact):
            check(g.shape == w.shape, f"K3 {what} {name}: shape")
            worst[name] = float((g - w).abs().max())
            scale[name] = max(1.0, float(w.abs().max()))
            rounding[name] = (float((g.double() - x).abs().max()),
                              float((w.double() - x).abs().max()))
            check(worst[name] <= K3_ATOL * scale[name],
                  f"K3 {what} {name}: disagrees with plain version")
        log(f"K3 {what}, B={B}: max|kernel - plain| {json.dumps(worst)}, "
            f"limit {K3_ATOL} x max(1, max|plain|) {json.dumps(scale)}; "
            f"kernel / plain against float64 {json.dumps(rounding)}")
        err = max(err, *worst.values())
    return err


def k3_raises(model, what: str, device) -> str:
    """The wrapper must raise ValueError before any launch on `model`."""
    q, qd = k3_inputs(model, 4, device)
    before = cuda_fk.fk_derivatives_batched.launches
    try:
        cuda_fk.fk_derivatives_batched(model, q, qd)
        raised = None
    except ValueError as e:
        raised = str(e)
    check(raised is not None
          and cuda_fk.fk_derivatives_batched.launches == before,
          f"K3 {what}: no ValueError before a launch")
    log(f"K3 {what} raises: {raised}")
    return raised


def k3_times(model, what: str, device) -> dict:
    """K3 on `model` at BATCH timed as phase 5 times it, one device kernel
    per call, its bound from these shapes."""
    q, qd = k3_inputs(model, BATCH, device)

    def call():
        return cuda_fk.fk_derivatives_batched(model, q, qd)
    per_call = device_launches(call, "fk_derivatives_kernel", f"K3 {what}")
    check(per_call == 1, f"K3 {what}: not one launch per wrapper call")
    rec = dict(frames=model.n_frames, n=model.n_q,
               tile_envs=cuda_fk.tile_of(model)[2],
               dynamic_smem_bytes=_build.c_function(
                   "rmp_fk_derivatives_shared_bytes",
                   [ctypes.c_int, ctypes.c_int])(model.n_frames, model.n_q),
               envs_per_sm=_build.c_function(
                   "rmp_fk_derivatives_envs_per_sm",
                   [ctypes.c_int, ctypes.c_int])(model.n_frames, model.n_q),
               device_launches_per_call=per_call, ms=time_ms(call),
               device_ms=time_ms(call, lead=True),
               plain_ms=time_ms(lambda: fk_derivatives(model, q, qd),
                                reps=5),
               library_ms=None)
    rec["bound_ms"], rec["bound_by"] = k3_bound(model, BATCH)
    log(f"K3 {what} times at B={BATCH}: wrapper {rec['ms']:.4f} ms (device "
        f"alone {rec['device_ms']:.4f} ms), plain {rec['plain_ms']:.4f} ms, "
        f"bound {rec['bound_ms']:.6f} ms ({rec['bound_by']}); tile "
        f"{rec['tile_envs']} envs, {rec['dynamic_smem_bytes']} B of shared "
        f"memory per CTA, {rec['envs_per_sm']} envs per SM")
    return rec


def phase_k3_wide(card: str, device) -> tuple[dict, float]:
    """K3 past 18 motors: each instantiation's build line; the kernel
    against its plain version on k3_wide_models at B = 4096, 1, 7, 4093
    (the models past the wide tile, and 73 frames and 65 motors raising
    before a launch, are phase 23's); the two planar arms
    of the path timed beside their bounds, with the wide kernel's shared
    bytes per CTA and envs per SM, and the Panda and the dual Panda (the
    narrow instantiation) timed again beside K3_EARLIER_MS."""
    build = {k: build_counts(source, f"K3 {k}", kernel)
             for k, (source, kernel) in K3_INSTANTIATIONS.items()}
    err = max(k3_check(m, what, device)
              for what, m in k3_wide_models().items())
    times = {f"planar_{n}": k3_times(planar_model(n), f"planar_{n}link",
                                     device) for n in WIDE_LINKS}
    for name, model in (("panda", robots.franka_panda()),
                        ("dual_panda", robots.dual_panda())):
        times[name] = k3_times(model, name, device)
        times[name]["earlier_device_ms"] = K3_EARLIER_MS[name]
        log(f"K3 {name} (narrow tile) device {times[name]['device_ms']:.4f} "
            f"ms beside {K3_EARLIER_MS[name]} ms before the wide tile "
            f"[{card}]")
    return dict(build=build, times=times), err


K1_RESIDUAL = 1e-5    # float64 backward error of a float32 solve, K1 and plain


def k1_compare_conditioned(tags, blocks, what: str) -> float:
    """K1 where the system's conditioning decides float32 q̈ (the long
    planar arms: the attractor's rank-3 metric over 12-16 m of links beside
    damping metrics of 0.005): kernel and plain version each against the
    plain version in float64 on the same blocks. The kernel's backward
    error in float64, |A x - f| / (|A| |x| + |f|) (infinity norms), within
    K1_RESIDUAL on every env, as a stable float32 LU keeps it whatever the
    conditioning; its largest forward error, |x - x64| / max(1, |x64|),
    within K1_TOL or twice the plain version's (two float32 solves round
    independently). Returns max |kernel - plain|, which is printed with
    both errors."""
    got = cuda_resolve.pullback_resolve_structured(tags, blocks)
    want = cuda_resolve.pullback_resolve_structured_plain(tags, blocks)
    wide = [tuple(x.double() for x in blk) for blk in blocks]
    exact = cuda_resolve.pullback_resolve_structured_plain(tags, wide)
    A, f = cuda_resolve.assemble_structured(tags, wide)
    torch.cuda.synchronize()
    scale = exact.abs().amax(dim=1).clamp_min(1.0)

    def forward(x):
        return float(((x.double() - exact).abs().amax(dim=1) / scale).max())

    def backward(x):
        x = x.double()
        r = (torch.einsum("bnm,bm->bn", A, x) - f).abs().amax(dim=1)
        return float((r / (A.abs().sum(dim=2).amax(dim=1)
                           * x.abs().amax(dim=1)
                           + f.abs().amax(dim=1))).max())
    gap = float((got - want).abs().max())
    fwd_k, fwd_p = forward(got), forward(want)
    bwd_k, bwd_p = backward(got), backward(want)
    log(f"K1 {what}: max|kernel - plain| {gap:.3e} (max|q̈| "
        f"{float(exact.abs().max()):.3e}); against float64, kernel / plain: "
        f"forward {fwd_k:.3e} / {fwd_p:.3e} (limit max({K1_TOL}, 2 x plain)),"
        f" backward {bwd_k:.3e} / {bwd_p:.3e} (limit {K1_RESIDUAL})")
    check(bool(torch.isfinite(got).all()), f"K1 {what}: non-finite output")
    check(bwd_k <= K1_RESIDUAL, f"K1 {what}: backward error")
    check(fwd_k <= max(K1_TOL, 2.0 * fwd_p), f"K1 {what}: forward error")
    return gap


def phase_k1_planar(device) -> tuple[dict, float]:
    """K1 on the planar arms' real ticks (WIDE_LINKS: the warp kernel at
    n = 24 and 32 with its largest tiles) against its plain version at
    B = 4096, 1, 7 and 4093 on the tick's own strided blocks, behind a
    float64 screen (k1_compare_conditioned); one device
    kernel per call; timed at B = 4096 beside its bound and einsum +
    torch.linalg.solve."""
    out, err = {}, 0.0
    for n_links in WIDE_LINKS:
        env = planar.planar_arm_env(n_links)
        for B in (BATCH,) + RAGGED:
            tags, blocks = real_tick_blocks(env, B, n_links)
            err = max(err, k1_compare_conditioned(
                tags, blocks, f"planar_{n_links}link (n={n_links}) real "
                f"tick, B={B}"))
        tags, blocks = real_tick_blocks(env, BATCH, n_links)

        def call():
            return cuda_resolve.pullback_resolve_structured(tags, blocks)
        per_call = device_launches(call, "pullback_resolve_wide_kernel",
                                   f"K1 n={n_links}")
        check(per_call == 1, f"K1 n={n_links}: not one launch per call")
        rec = k1_times(f"planar_{n_links}link real tick", tags, blocks)
        rec.update(n=n_links, device_launches_per_call=per_call,
                   layout=[[t, b[0].shape[1] if t != "identity" else 0]
                           for t, b in zip(tags, blocks)],
                   build=ptxas_counts(K1_WIDE_SOURCE,
                                      f"pullback_resolve_wide_kernelILi"
                                      f"{n_links}E"))
        out[f"n={n_links}"] = rec
    return out, err


def free_port() -> int:
    """A port of the loopback address that nothing holds."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def piercing_envs(env) -> int:
    """Envs of the reset that a link starts inside the env's obstacle."""
    states = envs.make_batched_reset(env, BATCH)()
    return int((min_clearance(env, states.sim) < 0.0).sum())


def phase_sharded(card: str, device) -> tuple[dict, dict]:
    """M16 at world size 1 on NCCL (loopback): make_sharded_rollout of the
    flagship scene ('solve', 4096 x SHARDED_TICKS from perturbed resets)
    against make_rollout on the same states (q, q̇ bit for bit, the three
    metrics, the launch counts), its collectives audited (scalar
    all-reduces only), the sharded checkpoint of its final states
    restored bit for bit, the process group destroyed."""
    port = free_port()
    distributed.initialize(f"127.0.0.1:{port}", 1, 0, device=device)
    try:
        backend = "nccl" if device.type == "cuda" else "gloo"
        check(torch.distributed.get_backend() == backend,
              f"M16: not {backend}")
        mesh = distributed.global_env_mesh()
        env = envs.make(SCENE)
        env.resolve_method = "solve"
        params = env.gather_params()
        states = perturbed_states(env, BATCH, 13, 0.1, 0.05)
        local = shard_env_batch(states, mesh)
        rollout = make_sharded_rollout(env, SHARDED_TICKS, mesh,
                                       collect_aux=True)
        torch.cuda.synchronize()
        _zero_counters()
        t0 = time.perf_counter()
        with record_collectives() as rec:
            final, metrics, _ = rollout(local, params)
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t0
        launches = _read_counters()
        audit = audit_collectives(rec)
        _zero_counters()
        t0 = time.perf_counter()
        want, aux = envs.make_rollout(env, SHARDED_TICKS)(states, params)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        plain_launches = _read_counters()
        want_metrics = dict(
            success_rate=aux["solved"].any(dim=1).float().mean(),
            goals_reached=want.solved_count.float().mean(),
            mean_abs_qdd=aux["qdd"].abs().mean())
        same = dict(q=torch.equal(final.sim.q, want.sim.q),
                    qd=torch.equal(final.sim.qd, want.sim.qd),
                    **{k: bool(metrics[k] == v)
                       for k, v in want_metrics.items()})
        with tempfile.TemporaryDirectory() as path:
            save_checkpoint_sharded(path, final)
            back = restore_checkpoint_sharded(path, final)
        restored = all(torch.equal(a, b) if isinstance(a, torch.Tensor)
                       else torch.equal(a.get_state(), b.get_state())
                       for a, b in zip(ckpt_leaves(back), ckpt_leaves(final)))
    finally:
        distributed.shutdown()
    check(not torch.distributed.is_initialized(), "M16: group not destroyed")
    res = dict(envs=BATCH, ticks=SHARDED_TICKS, backend=backend, world=1,
               equal=same, audit=audit, launches=launches,
               make_rollout_launches=plain_launches,
               metrics={k: float(v) for k, v in metrics.items()},
               sharded_s=sharded_s, make_rollout_s=plain_s,
               checkpoint_bit_for_bit=restored)
    log(f"M16 sharded {SCENE} at world size 1 ({backend}): "
        f"{json.dumps(res)} [{card}]")
    check(all(same.values()), f"M16: sharded differs from make_rollout "
          f"{same}")
    check(audit["all_reduce"] == 5, f"M16: {audit}")
    check(launches == plain_launches, "M16: launches differ from "
          "make_rollout's")
    check(restored, "M16: the sharded checkpoint does not restore")
    return launches, res


def phase_tools(card: str, device, failed: list) -> dict:
    """M17 on the card: the evaluate CLI as a subprocess on the randomized
    scene at 4096 x 300 (its statistics against reports/eval_randomized.json
    within 3 sigma, nan_rate 0), latency.measure on the flagship at
    LATENCY_BATCHES, the soak at 4096 x SOAK_TICKS in chunks of
    SOAK_CHUNK (finite, in limits), `run franka/01 --ticks 40`."""
    out = {}
    cpu = ["--cpu"] if device.type == "cpu" else []
    t0 = time.perf_counter()
    ev = subprocess.run(
        [sys.executable, "-m", "rmp_tpu_torch.experiments.evaluate",
         "--env", RANDOMIZED, "--batch", str(BATCH), "--ticks",
         str(RANDOMIZED_TICKS), "--seed", str(RANDOMIZED_SEED), *cpu],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(ev.returncode == 0, f"evaluate CLI failed: {ev.stderr[-2000:]}")
    report = json.loads(ev.stdout)
    with open(os.path.join(ROOT, REPORTS["capsule"])) as f:
        ref = json.load(f)
    against = {}
    for key in STAT_KEYS:
        p = ref[key]
        against[key] = dict(port=report[key], report=p,
                            diff=report[key] - p, limit=stat_limit(p))
        if abs(report[key] - p) > stat_limit(p):
            failed.append(f"evaluate CLI: {key} {report[key]:.5f} against "
                          f"{p:.5f} (limit {stat_limit(p):.5f})")
    if report["nan_rate"] != 0.0:
        failed.append(f"evaluate CLI: nan_rate {report['nan_rate']}")
    out["evaluate"] = dict(report=report, against_report=against,
                           process_s=time.perf_counter() - t0)
    log(f"evaluate CLI ({RANDOMIZED}, {BATCH} x {RANDOMIZED_TICKS}): "
        f"{report['control_steps_per_sec']} control steps/s "
        f"[{report['device']}]; {json.dumps(against)}")
    out["latency"] = latency.measure(SCENE, list(LATENCY_BATCHES),
                                     LATENCY_TICKS, "capsule", device=device)
    log(f"latency ({SCENE}): {json.dumps(out['latency'])}")
    out["soak"] = soak.soak(SCENE, BATCH, SOAK_TICKS, SOAK_CHUNK, "capsule",
                            device=device)
    log(f"soak ({SCENE}, {BATCH} x {SOAK_TICKS}): {json.dumps(out['soak'])}")
    check(out["soak"]["all_finite"] and out["soak"]["always_in_limits"],
          "soak: non-finite or out of limits")
    # what nothing times, together once the timed work above is done: the
    # run entry point, and phases 20 and 21's run with a GIF and asset tools
    cmds = {"run": RUN + ["franka/01_target_rmp_only", "--ticks", "40",
                          *cpu]}
    if not cpu:
        os.makedirs(os.path.dirname(GIF_RUN), exist_ok=True)
        cmds.update({"run --gif": GIF_RUN_CMD,
                     "asset tools": asset_tools_cmd(card)})
    _RAN.update(run_together(cmds))
    stdout, process_s = ran("run", cmds["run"])
    out["run"] = dict(tail=stdout.strip().splitlines()[-4:],
                      process_s=process_s, beside=sorted(set(cmds) - {"run"}))
    log(f"run franka/01 --ticks 40: {json.dumps(out['run'])}")
    return out


def phase_slice13(card: str, device) -> dict:
    """Phase 19: K3 past 18 motors, K1 on the planar real ticks at n = 24
    and 32, the 24- and 32-link arms at 4096 x 150 with GPU/CPU parity, M16
    at world size 1 on NCCL, the M17 entry points on the card."""
    t_start = time.perf_counter()
    failed: list = []
    k3, k3_err = phase_k3_wide(card, device)
    k1, k1_err = phase_k1_planar(device)
    paths, results = {}, {}
    k13 = ("pullback_resolve_structured", "fk_derivatives_batched")
    for n_links in WIDE_LINKS:
        name = f"planar_{n_links}link"
        env = planar.planar_arm_env(n_links)
        pierce = piercing_envs(env)
        log(f"{name}: {pierce} of {BATCH} envs start with a link inside "
            f"the cylinder")
        launches, res = rollout_path(card, env, name, PLANAR_TICKS, k13,
                                     failed)
        res["piercing_at_start"] = pierce
        res["parity"] = gpu_cpu_parity(
            lambda dev: planar.planar_arm_env(n_links, dev), name)
        paths[name], results[name] = launches, res
    t0 = time.perf_counter()
    paths[f"sharded {SCENE} (world 1)"], sharded = phase_sharded(card,
                                                                  device)
    sharded_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tools = phase_tools(card, device, failed)
    tools_s = time.perf_counter() - t0
    seconds = time.perf_counter() - t_start
    log(f"phase 19: {seconds:.1f} s (M16 {sharded_s:.1f} s, M17 tools "
        f"{tools_s:.1f} s)")
    check(not failed, "; ".join(failed))
    return dict(k3=k3, k3_err=k3_err, k1=k1, k1_err=k1_err,
                results=results, sharded=sharded, tools=tools,
                paths={k: (v, results.get(k, sharded)) for k, v in
                       paths.items()},
                seconds=dict(all=seconds, sharded=sharded_s, tools=tools_s))


# ------------------------------------------------ the fourteenth slice ----

K5_WIDE_LINKS = (17, 24, 32)  # the arms past the 16-lane K5: 17 pads to 24
K5_WIDE_INSTANTIATIONS = {24: "fused_qdd_wide_kernelILi24E",
                          32: "fused_qdd_wide_kernelILi32E"}
# K5's scene 06 time on an H100 80GB HBM3 at 700 W, device alone at
# B = 4096 (PERF.md): the 16-lane kernel must keep it
K5_EARLIER_MS = 0.0375
K5_KEEP = 1.05


def k5_backward(x, A, f) -> torch.Tensor:
    """Per env |A x - f| / (|A| |x| + |f|) (infinity norms) in float64:
    the backward error of a solve of the float64 system (A, f)."""
    x = x.double()
    r = (torch.einsum("bnm,bm->bn", A, x) - f).abs().amax(dim=1)
    return r / (A.abs().sum(dim=2).amax(dim=1) * x.abs().amax(dim=1)
                + f.abs().amax(dim=1))


def k5_held(want, cpu_want, exact) -> torch.Tensor:
    """The (B,) envs held to the plain version: both float32 plain runs,
    on the card (`want`) and on the CPU (`cpu_want`, the same arithmetic
    rounded elsewhere), within K5_ACCURATE of the float64 one (`exact`).
    One run alone is a draw where a one-ulp change of the FK's rounding
    moves q̈ by ~6e-4: an env of the 31-link arm (env 1954 of
    planar_inputs(.., 11), a link 5 mm into the cylinder) lands 7.0e-6 from
    float64 in the card's plain run, 2.3e-5 in the CPU's and 6.3e-4 in
    either CUDA kernel's, and the plain version on the float64 FK rounded
    to float32 with one-ulp noise lands on 6.3e-4 in 6 of 20 draws (CPU
    runs, PR 20)."""
    return ((k5_rel(want.double(), exact) <= K5_ACCURATE)
            & (k5_rel(cpu_want.double(), exact) <= K5_ACCURATE))


def k5_wide_check(env, args, what: str, cpu_want) -> dict:
    """The wide K5 against its plain version on the envs whose float32
    plain runs a float64 one keeps within K5_ACCURATE (k5_held; 2e-4 x
    max(1, |q̈|)); on the rest against the float64 system, kernel beside plain as
    k1_compare_conditioned holds K1: the backward error |A x - f| / (|A|
    |x| + |f|) within max(K1_RESIDUAL, twice the plain version's) and the
    forward error within max(K1_TOL, twice the plain version's), each at
    the 99th percentile of the rest. The largest of each are printed, not
    held: on envs whose links pierce the cylinder the 1/d curvature row
    turns float32 rounding into q̈ errors of up to ~1e-2 of |q̈| in either
    run (4.3e-3 plain, 1.5e-2 kernel at 32 links on an H100 80GB HBM3 at
    700 W), so the worst env of two float32 runs is a draw; the worst
    env's clearance is printed beside them."""
    tick = cuda_tick.fused_tick(env)
    got = cuda_tick.fused_qdd(tick, *args)
    want = cuda_tick.fused_qdd_plain(tick, *args)
    A, f = cuda_tick.fused_qdd_system(tick, *(x.double() for x in args))
    exact = cuda_tick.fused_qdd_plain(tick, *(x.double() for x in args))
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"K5 {what}: non-finite")
    plain_err = k5_rel(want.double(), exact)
    kern_err = k5_rel(got.double(), exact)
    bwd_k, bwd_p = k5_backward(got, A, f), k5_backward(want, A, f)
    held = k5_held(want, cpu_want, exact)
    rest = ~held
    rel = k5_rel(got, want)
    gap = float(rel[held].max()) if held.any() else 0.0

    def q99(x):
        return float(torch.quantile(x[rest], 0.99)) if rest.any() else 0.0
    worst = int(kern_err.argmax())
    sim = SimState(q=args[0], qd=args[1], t=torch.zeros_like(args[0][:, 0]),
                   obstacles=collision.ObstacleSet(*args[3:],
                                                   kinds=("cylinder",)),
                   goal=args[2])
    rec = dict(envs=got.shape[0], held=int(held.sum()), gap=gap,
               backward_p99=q99(bwd_k), plain_backward_p99=q99(bwd_p),
               forward_p99=q99(kern_err), plain_forward_p99=q99(plain_err),
               backward_max=float(bwd_k.max()),
               plain_backward_max=float(bwd_p.max()),
               forward_max=float(kern_err.max()),
               plain_forward_max=float(plain_err.max()),
               worst_env_clearance=float(min_clearance(env, sim)[worst]))
    log(f"K5 {what}: {rec['held']} of {rec['envs']} envs held, kernel vs "
        f"plain {gap:.3e} (limit {K1_TOL}); on the rest, kernel / plain p99 "
        f"backward {rec['backward_p99']:.3e} / "
        f"{rec['plain_backward_p99']:.3e} (limit max({K1_RESIDUAL}, 2 x "
        f"plain)), forward {rec['forward_p99']:.3e} / "
        f"{rec['plain_forward_p99']:.3e} (limit max({K1_TOL}, 2 x plain)); "
        f"largest backward {rec['backward_max']:.3e} / "
        f"{rec['plain_backward_max']:.3e}, forward {rec['forward_max']:.3e} "
        f"/ {rec['plain_forward_max']:.3e} (the kernel's worst env: plain "
        f"{float(plain_err[worst]):.3e}, clearance "
        f"{rec['worst_env_clearance']:.4f} m)")
    check(rec["held"] >= got.shape[0] // 2, f"K5 {what}: too few envs held")
    check(gap <= K1_TOL, f"K5 {what}: kernel vs plain")
    check(rec["backward_p99"] <= max(K1_RESIDUAL,
                                     2.0 * rec["plain_backward_p99"]),
          f"K5 {what}: backward error")
    check(rec["forward_p99"] <= max(K1_TOL, 2.0 * rec["plain_forward_p99"]),
          f"K5 {what}: forward error against float64")
    return rec


def k5_tail_env(arm, extra: int):
    """The planar env on fixed_tail_model(n, extra, spheres) of the arm env
    `arm` (the grouped obstacle policy over every collision frame), for K5
    alone."""
    return planar.planar_env(fixed_tail_model(arm.model.n_q, extra,
                                              radius=0.04), arm.device)


K5_WIDE_ODD = (19, 31)  # odd n, padded to 24 and 32
K5_WIDE_TAIL = "planar_32 + 7 fixed (F=40, 40 collision)"
K5_WIDE_CYLINDERS = 4   # the obstacles an env of the K = 4 layout


def k5_cylinders(args, K: int, seed: int):
    """K5's inputs `args` with K cylinders an env: its own and K - 1 copies
    moved 0.8-1.2 m in the x-y plane (seeded), within the obstacle policy's
    reach of some links. Nearer copies pierce more links, where the 1/d
    curvature rows leave fewer envs that float32 solves well (60% of 256
    at 0-0.5 m, 66% here, 84% with the one cylinder; CPU run)."""
    q, qd, goal, p0, p1, r = args
    B = q.shape[0]
    rng = np.random.default_rng(seed)
    shift = np.zeros((B, K, 3), np.float32)
    mag = rng.uniform(0.8, 1.2, (B, K - 1))
    ang = rng.uniform(0.0, 2.0 * np.pi, (B, K - 1))
    shift[:, 1:, 0], shift[:, 1:, 1] = mag * np.cos(ang), mag * np.sin(ang)
    shift = torch.tensor(shift, device=q.device)
    return (q, qd, goal, (p0 + shift).contiguous(), (p1 + shift).contiguous(),
            r.expand(B, K).contiguous())


def k5_wide_layouts(B: int = BATCH, seed: int = 11) -> dict:
    """The wide K5's layouts, name -> (env, its inputs at B): the 17-, 24-,
    32-link arms and n = 19, 31 (planar_inputs); the 32-link arm with 7
    fixed tail links carrying spheres (F = 40, 40 collision frames) on the
    arm's inputs; the branched tree (F = 30, n = 28) under the planar
    policies; the 32-link arm with K5_WIDE_CYLINDERS cylinders an env."""
    out = {}
    for n_links in K5_WIDE_LINKS + K5_WIDE_ODD:
        env = planar.planar_arm_env(n_links)
        out[f"planar_{n_links}"] = (env, planar_inputs(env, B, seed))
    arm, args = out[f"planar_{K5_WIDE_LINKS[-1]}"]
    out[K5_WIDE_TAIL] = (k5_tail_env(arm, 7), args)
    tree = planar.planar_env(branched_model())
    out["branched 20 + 8 (F=30, n=28)"] = (tree, planar_inputs(tree, B, seed))
    out[f"planar_32, K={K5_WIDE_CYLINDERS}"] = (
        arm, k5_cylinders(args, K5_WIDE_CYLINDERS, seed))
    return out


def k5_held_error(tick, args) -> float:
    """The largest |kernel - plain| / max(1, |plain|) over k5_wide_check's
    held envs (k5_held)."""
    got = cuda_tick.fused_qdd(tick, *args)
    want = cuda_tick.fused_qdd_plain(tick, *args)
    exact = cuda_tick.fused_qdd_plain(tick, *(x.double() for x in args))
    cpu_want = cuda_tick.fused_qdd_plain(tick, *(x.cpu() for x in args))
    held = k5_held(want, cpu_want.to(want.device), exact)
    return float(k5_rel(got, want)[held].max()) if held.any() else 0.0


def k5_wide_residency(tick) -> dict:
    """The wide K5's dynamic shared memory a CTA at the tick's model, and
    the envs an SM holds at once (None where the library has no such
    entry point)."""
    model, n_col = tick.model, len(tick.col_frames)
    sizes = (model.n_frames, model.n_q, n_col)
    rec = dict(shared_bytes=_build.c_function(
        "rmp_fused_qdd_wide_shared_bytes", [ctypes.c_int] * 3)(*sizes))
    try:
        envs_per_sm = _build.c_function("rmp_fused_qdd_wide_envs_per_sm",
                                        [ctypes.c_int] * 3)
    except AttributeError:
        return dict(rec, envs_per_sm=None)
    return dict(rec, envs_per_sm=envs_per_sm(*sizes))


def phase_k5_wide(card: str, device) -> tuple[dict, float]:
    """K5 past 16 motors: the wide kernel's two instantiations' build
    lines; the kernel on every layout of k5_wide_layouts at B = 4096 (the
    17-, 24- and 32-link arms also at B = 1, 7 and 4093) against its plain
    version behind the float64 screen (k5_wide_check), each layout's
    device time beside its shared memory a CTA and envs an SM; at 24 and
    32 links one device kernel a call and the wrapper's and the plain
    version's times beside the bound; the capacity (40 frames and 40
    collision frames); 33 motors, 41 frames and grad raising before a
    launch; the 16-lane kernel re-timed on scene 06 against
    K5_EARLIER_MS."""
    builds = {n: build_counts("fused_tick_wide.cu", f"K5 wide <{n}>", k)
              for n, k in K5_WIDE_INSTANTIATIONS.items()}
    layouts = k5_wide_layouts()
    arms = {f"planar_{n}" for n in K5_WIDE_LINKS}
    out, err = {"layouts": {}}, 0.0
    for name, (env, args) in layouts.items():
        tick = cuda_tick.fused_tick(env)
        check(cuda_tick.wide(tick), f"K5 {name}: not the wide kernel")
        fn = cuda_tick.make_fused_qdd(env)
        cpu_want = cuda_tick.fused_qdd_plain(
            tick, *(x.cpu() for x in args)).to(device)
        checks = {B: k5_wide_check(env, tuple(x[:B].contiguous()
                                              for x in args),
                                   f"wide, {name}, B={B}", cpu_want[:B])
                  for B in (BATCH,) + (RAGGED if name in arms else ())}
        err = max([err] + [c["gap"] for c in checks.values()])
        rec = dict(frames=tick.model.n_frames, n=tick.model.n_q,
                   collision_frames=len(tick.col_frames),
                   obstacles=args[5].shape[1], checks=checks,
                   device_ms=time_ms(lambda: fn(*args), lead=True),
                   **k5_wide_residency(tick))
        log(f"K5 wide {name} (F={rec['frames']}, n={rec['n']}, "
            f"{rec['collision_frames']} collision frames, K="
            f"{rec['obstacles']}) at B={BATCH}: device {rec['device_ms']:.4f}"
            f" ms, {rec['shared_bytes']} B of shared memory a CTA, "
            f"{rec['envs_per_sm']} envs an SM [{card}]")
        out["layouts"][name] = rec
    for n_links in K5_WIDE_LINKS[1:]:
        env, args = layouts[f"planar_{n_links}"]
        tick = cuda_tick.fused_tick(env)
        fn = cuda_tick.make_fused_qdd(env)
        per_call = device_launches(lambda: fn(*args), "fused_qdd_wide_kernel",
                                   f"K5 wide n={n_links}")
        check(per_call == 1, "K5 wide: not one launch per wrapper call")
        b_ms, b_by = k5_bound(tick, BATCH, 1)
        total, mirrored = tick_ops.fused_qdd_ops(tick, 1)
        lay = out["layouts"][f"planar_{n_links}"]
        rec = dict(n=n_links, frames=tick.model.n_frames,
                   collision_frames=len(tick.col_frames),
                   ms=time_ms(lambda: fn(*args)),
                   device_ms=lay["device_ms"],
                   plain_ms=time_ms(lambda: cuda_tick.fused_qdd_plain(
                       tick, *args), reps=5),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None,
                   ops_per_env=total - mirrored,
                   device_launches_per_call=per_call,
                   dynamic_smem_bytes=lay["shared_bytes"],
                   envs_per_sm=lay["envs_per_sm"],
                   build=builds[24 if n_links <= 24 else 32])
        log(f"K5 wide planar_{n_links}link times at B={BATCH}: kernel "
            f"{rec['ms']:.4f} ms (device alone {rec['device_ms']:.4f} ms), "
            f"plain {rec['plain_ms']:.4f} ms, bound {b_ms:.6f} ms ({b_by}, "
            f"{total - mirrored} operations per env, "
            f"{(total - mirrored) * BATCH / rec['device_ms'] / 1e9:.2f} "
            f"TFLOP/s achieved); {rec['dynamic_smem_bytes']} B of shared "
            f"memory a CTA, {rec['envs_per_sm']} envs an SM [{card}]")
        out[f"planar_{n_links}"] = rec
    # the capacity: 40 frames and 40 collision frames (the 32-link arm and
    # 7 fixed tail links with a sphere each), checked above
    arm, args = layouts[f"planar_{K5_WIDE_LINKS[-1]}"]
    tail = layouts[K5_WIDE_TAIL][0]
    check((tail.model.n_frames, len(cuda_tick.fused_tick(tail).col_frames))
          == (cuda_tick.MAX_FRAMES, cuda_tick.MAX_COLLISION),
          "K5: the capacity model is not 40 frames and 40 collision frames")
    raised = []
    for env_big, big_args in (
            (planar.planar_arm_env(33),
             planar_inputs(planar.planar_arm_env(33), 4, 11)),
            (k5_tail_env(arm, 8), tuple(x[:4].contiguous() for x in args))):
        try:
            cuda_tick.make_fused_qdd(env_big)(*big_args)
            raised.append(None)
        except ValueError as exc:
            raised.append(str(exc))
    check(all(r is not None and "capacity" in r for r in raised),
          "K5: 33 motors or 41 frames did not raise")
    small = planar.planar_arm_env(24)
    grad_args = list(planar_inputs(small, 4, 11))
    grad_args[0] = grad_args[0].clone().requires_grad_(True)
    before = cuda_tick.fused_qdd.launches
    try:
        cuda_tick.make_fused_qdd(small)(*grad_args)
        raised.append(None)
    except RuntimeError as exc:
        raised.append(str(exc))
    check(raised[2] is not None and cuda_tick.fused_qdd.launches == before,
          "K5 wide: did not raise under grad before a launch")
    log(f"K5 raises: 33 motors: {raised[0]!r}; 41 frames: {raised[1]!r}; "
        f"under grad: {raised[2]!r}")
    env06 = envs.make(SCENE)
    fn06 = cuda_tick.make_fused_qdd(env06)
    near = k5_inputs(env06, BATCH, 11, wide=False)
    narrow_ms = time_ms(lambda: fn06(*near), lead=True)
    log(f"K5 16-lane kernel, scene 06 re-timed: device {narrow_ms:.4f} ms "
        f"(earlier {K5_EARLIER_MS}, limit x{K5_KEEP}) [{card}]")
    check(narrow_ms <= K5_KEEP * K5_EARLIER_MS, "K5 scene 06 slowed")
    out["scene06_device_ms"] = narrow_ms
    out["narrow_build"] = ptxas_counts("fused_tick.cuh",
                                       "fused_qdd_kernelILi9E")
    out["raises"] = raised
    return out, err


SWEEP_CUT = dict(envs_per_config=256, ticks=100)   # of 256 x 300 by default
ESCAPE_CUT = dict(batch=256, ticks=15)             # of 4096 x 300; 30 before
                                                   # the fifteenth slice
SHARDED_RANDOM = dict(envs=1024, ticks=30, solved_tol=0.5)
TRACE_TICKS = 10
TRACE_TOL = 0.10       # trace_report's K1 / K3 us per tick against phase 7
GJK_CUT = dict(batch=1024, ticks=20)               # of 1024 x 150
GIF_TICKS, GIF_EVERY = 12, 4     # 24 ticks before the fifteenth slice


def phase_sharded_random(card: str, device) -> dict:
    """Part A on the card: the randomized Panda (its draws every tick and
    on every goal event; the solved check widened so that goals resample)
    sharded at world size 1 on NCCL, against make_rollout on the same
    states, bit for bit, with resamples drawn."""
    port = free_port()
    distributed.initialize(f"127.0.0.1:{port}", 1, 0, device=device)
    try:
        mesh = distributed.global_env_mesh()
        env = envs.make(RANDOMIZED)
        env.solved_tol = SHARDED_RANDOM["solved_tol"]
        params = env.gather_params()
        B, ticks = SHARDED_RANDOM["envs"], SHARDED_RANDOM["ticks"]
        states = envs.make_batched_reset(env, B, 3)()
        again = envs.make_batched_reset(env, B, 3)()
        local = shard_env_batch(states, mesh)
        final, _, aux = make_sharded_rollout(env, ticks, mesh,
                                             collect_aux=True)(local, params)
        want, want_aux = envs.make_rollout(env, ticks)(again, params)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(
            ckpt_leaves(final), ckpt_leaves(want))
            if isinstance(a, torch.Tensor))
        same = same and torch.equal(final.rng.get_state(),
                                    want.rng.get_state())
        resamples = int(aux["resample"].sum())
    finally:
        distributed.shutdown()
    rec = dict(envs=B, ticks=ticks, resamples=resamples, equal=same,
               resamples_unsharded=int(want_aux["resample"].sum()))
    log(f"part A: {RANDOMIZED} sharded at world size 1 (NCCL), {B} x "
        f"{ticks}, solved_tol {SHARDED_RANDOM['solved_tol']}: "
        f"{json.dumps(rec)} [{card}]")
    check(same and resamples > 0, "part A: sharded randomized rollout "
          "differs from make_rollout, or drew no resample")
    return rec


def _port_us(per_tick: dict, part: str) -> float:
    return sum(v for k, v in per_tick.items() if part in k)


def phase_tools14(card: str, device, main_trace: dict) -> dict:
    """M17's second half on the card: sweep_randomized (G = 2) and the
    dual scene's sweep_escape at SWEEP_CUT / ESCAPE_CUT; trace_report's K1
    and K3 us per tick on the flagship within TRACE_TOL of phase 7's
    profile; profile_tick; gjk_warm_accuracy (K4, GJK_CUT); make_gifs,
    Simulation's capture and `run --gif`, each through the native
    renderer, into chiprun_out/; the viewer's HTTP round trip."""
    from rmp_tpu_torch.experiments import (gjk_warm_accuracy, make_gifs,
                                           profile_tick, sweep_escape,
                                           sweep_randomized, trace_report)
    from rmp_tpu_torch.utils import native
    from rmp_tpu_torch.utils.viewer import SimViewer
    import urllib.request as rq

    out, seconds = {}, {}
    t0 = time.perf_counter()
    log(f"sweep_randomized cut to {json.dumps(SWEEP_CUT)} (default 256 "
        f"envs a config x 300 ticks)")
    sw = sweep_randomized.sweep(
        RANDOMIZED, sweep_randomized.parse_axes(["accel_p_gain=0.3,2.5"]),
        SWEEP_CUT["envs_per_config"], SWEEP_CUT["ticks"], 0, device)
    log(f"sweep_randomized: {json.dumps(sw)} [{card}]")
    check(len(sw["results"]) == 2 and all(r["nan"] == 0.0
                                          for r in sw["results"]),
          "sweep_randomized: a config went non-finite")
    out["sweep_randomized"] = sw
    seconds["sweep_randomized"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log(f"sweep_escape (dual_panda/randomized_clutter) cut to "
        f"{json.dumps(ESCAPE_CUT)} (default 4096 x 300)")
    esc = sweep_escape.sweep("dual_panda/randomized_clutter",
                             ESCAPE_CUT["batch"], ESCAPE_CUT["ticks"], 0,
                             device, log=log)
    check(len(esc["groups"]) == 4, "sweep_escape: a config missing")
    out["sweep_escape"] = esc
    seconds["sweep_escape"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # K1 and K3 launch once a tick. The profiler may drop some of a trace's
    # device records (PERF.md section 7), so each kernel's us a tick is its
    # mean over the events the trace kept; at least one must be kept
    rep = trace_report.report(SCENE, BATCH, TRACE_TICKS, "capsule", device)
    kept = {part: sum(c for k, c in rep["counts"].items() if part in k)
            for part in ("pullback_resolve", "fk_derivatives_kernel")}
    log(f"trace_report: K1 / K3 device events kept {json.dumps(kept)} of "
        f"{TRACE_TICKS} launches each")
    check(all(0 < c <= TRACE_TICKS for c in kept.values()),
          f"trace_report: K1 / K3 device events {json.dumps(kept)} of "
          f"{TRACE_TICKS} launches each")
    phase7 = main_trace["port_kernels_us_per_tick"]
    compare = {}
    for what, part in (("K1", "pullback_resolve"),
                       ("K3", "fk_derivatives_kernel")):
        got = _port_us(rep["totals"], part) / kept[part]
        want = _port_us(phase7, part)
        compare[what] = dict(trace_report_us=got, events_kept=kept[part],
                             phase7_us=want,
                             ratio=got / want if want else None)
    out["trace_report"] = dict(
        device_us_per_tick=rep["device_us_per_tick"], against=compare,
        top=list(rep["totals"].items())[:8],
        top_sources=list(rep["source_totals"].items())[:8])
    log(f"trace_report ({SCENE}, {BATCH} x {TRACE_TICKS}): "
        f"{json.dumps(out['trace_report'])} [{card}]")
    for what, c in compare.items():
        check(c["ratio"] is not None and abs(c["ratio"] - 1.0) <= TRACE_TOL,
              f"trace_report: {what} {c} against phase 7")
    seconds["trace_report"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["profile_tick"] = profile_tick.profile(BATCH, device, iters=5)
    log(f"profile_tick: {json.dumps(out['profile_tick'])} [{card}]")
    t1 = time.perf_counter()
    _zero_counters()
    gw = gjk_warm_accuracy.run_one(SCENE, data.WARM_ITERS, GJK_CUT["batch"],
                                   GJK_CUT["ticks"], 0, device)
    gw["k4_launches"] = cuda_gjk.gjk_hull_obstacles.launches
    log(f"gjk_warm_accuracy cut to {json.dumps(GJK_CUT)} (default 1024 x "
        f"150): {json.dumps(gw)} [{card}]")
    check(gw["k4_launches"] >= 2 * GJK_CUT["ticks"]
          and np.isfinite(gw["qdd_abs_err_max"]),
          "gjk_warm_accuracy: K4 not run or q̈ non-finite")
    out["gjk_warm_accuracy"] = gw
    seconds["profile_tick"] = t1 - t0
    seconds["gjk_warm_accuracy"] = time.perf_counter() - t1
    t0 = time.perf_counter()
    check(native.available(), "the native renderer is not available")
    gif_dir = os.path.join(ROOT, "chiprun_out", "gifs")
    os.makedirs(gif_dir, exist_ok=True)
    gif = make_gifs.make_gif(SCENE, GIF_TICKS, GIF_EVERY, "capsule",
                             gif_dir, device)
    sim_path = os.path.join(gif_dir, "simulation.gif")
    sim_ = Simulation(animation_save_path=sim_path, device=device)
    sim_.populate_scene([FrankaPanda(), Goal([0.6, 0.0, 0.4])])
    for _ in range(40):
        sim_.step(np.zeros(9))
    sim_.save_animation()
    run_path = GIF_RUN
    stdout, _ = ran("run --gif", GIF_RUN_CMD)
    out["gifs"] = dict(make_gifs=gif, simulation=dict(
        path=sim_path, renderer=sim_.renderer, frames=len(sim_._frames)),
        run=stdout.strip().splitlines()[-1])
    log(f"gifs: {json.dumps(out['gifs'])}")
    check(gif["renderer"] == "native" and sim_.renderer == "native"
          and "native renderer" in out["gifs"]["run"]
          and all(os.path.getsize(p) > 0 for p in (gif["path"], sim_path,
                                                   run_path)),
          "gifs: not all written through the native renderer")
    seconds["gifs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    viewer = SimViewer(envs.make("two_joint/01_target_rmp_only"), port=0,
                       width=128, height=96, realtime=False).start()
    try:
        host, port = viewer.address
        base = f"http://{host}:{port}"
        deadline = time.time() + 60
        while json.loads(rq.urlopen(base + "/state", timeout=30).read())[
                "tick"] == 0:
            check(time.time() < deadline, "viewer: the sim thread idles")
            time.sleep(0.1)
        frame = rq.urlopen(base + "/frame.png", timeout=60).read()
        st = json.loads(rq.urlopen(base + "/state", timeout=30).read())
        rq.urlopen(rq.Request(base + "/pause", data=b"", method="POST"),
                   timeout=30).read()
    finally:
        viewer.stop()
    out["viewer"] = dict(tick=st["tick"], device=st["device"],
                         png_bytes=len(frame), renderer=viewer.renderer)
    log(f"viewer on localhost: {json.dumps(out['viewer'])}")
    check(frame[:8] == b"\x89PNG\r\n\x1a\n" and st["tick"] > 0
          and st["device"].startswith("cuda"), "viewer: round trip failed")
    seconds["viewer"] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out


def phase_slice14(card: str, device, main_trace: dict) -> dict:
    """Phase 20: K5 past 16 motors (phase_k5_wide), part A's row streams
    at world size 1 on NCCL (phase_sharded_random), and M17's second half
    (phase_tools14)."""
    t_start = time.perf_counter()
    k5, k5_err = phase_k5_wide(card, device)
    k5_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    sharded = phase_sharded_random(card, device)
    sharded_s = time.perf_counter() - t0
    tools = phase_tools14(card, device, main_trace)
    seconds = time.perf_counter() - t_start
    log(f"phase 20: {seconds:.1f} s (K5 {k5_s:.1f} s, part A "
        f"{sharded_s:.1f} s, tools {json.dumps(tools['seconds'])})")
    return dict(k5=k5, k5_err=k5_err, sharded=sharded, tools=tools,
                seconds=dict(all=seconds, k5=k5_s, sharded=sharded_s,
                             **tools["seconds"]))


AOT_DIR = os.path.join(ROOT, "chiprun_out", "aot")
AOT_CALLS = {"capsule": TICKS, "hull": 30}
AOT_CPU_BATCH, AOT_CPU_CALLS = 128, 5
# a serving host: torch and the ops module only. For each artifact
# (path, calls) on argv: load (moved to the card where it was traced on
# the CPU), `calls` closed-loop calls from its example state after a
# 2-call warm-up from the same state, timed; the wrappers' launch counters
# over those calls; device kernels a call over 10 more under
# torch.profiler; the final state leaves into <path>.final.npz. One JSON
# line per artifact, then the modules of the package it imported.
ARTIFACT_CHILD = r"""
import json, sys, time
import numpy as np, torch
from torch.profiler import ProfilerActivity, profile
import rmp_tpu_torch.ops.library
from rmp_tpu_torch.ops import cuda_fk, cuda_gjk, cuda_resolve

COUNTERS = {"pullback_resolve_structured":
                cuda_resolve.pullback_resolve_structured,
            "fk_derivatives_batched": cuda_fk.fk_derivatives_batched,
            "gjk_hull_obstacles": cuda_gjk.gjk_hull_obstacles}
args = sys.argv[1:]
for path, calls in zip(args[::2], map(int, args[1::2])):
    manifest = json.load(open(path + ".json"))
    t0 = time.perf_counter()
    ep = torch.export.load(path)
    if manifest["traced_on"] != "cuda":
        from torch.export.passes import move_to_device_pass
        ep = move_to_device_pass(ep, "cuda")
    step = ep.module()
    load_s = time.perf_counter() - t0
    ex = np.load(path + ".npz")
    leaves = [torch.from_numpy(ex[f"arr_{i}"]).cuda()
              for i in range(len(ex.files))]
    n = manifest["n_state_leaves"]
    params = leaves[n:]
    assert not manifest["draws"], "a scene that draws"

    def run(k):
        state = leaves[:n]
        for _ in range(k):
            state = list(step(*state, *params))
        return state
    t0 = time.perf_counter()
    run(1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    run(2)
    torch.cuda.synchronize()
    for fn in COUNTERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    state = run(calls)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in COUNTERS.items()}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s = state
        for _ in range(10):
            s = list(step(*s, *params))
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    np.savez(path + ".final.npz", *[x.cpu().numpy() for x in state])
    print(json.dumps(dict(path=path, calls=calls, load_s=load_s,
                          first_call_s=first_s, seconds=seconds,
                          steps_per_s=manifest["batch"] * calls / seconds,
                          launches=launches,
                          device_launches_per_call=len(kernels) / 10)),
          flush=True)
print(json.dumps(sorted(m for m in sys.modules
                        if m.startswith("rmp_tpu_torch."))))
"""


@spent()
def run_artifacts(runs: list) -> tuple[list, list]:
    """(one record per (path, calls) of `runs`, the package's modules the
    serving process imported), from ARTIFACT_CHILD in a fresh process."""
    cmd = [sys.executable, "-c", ARTIFACT_CHILD]
    for path, calls in runs:
        cmd += [path, str(calls)]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env={**os.environ, "PYTHONPATH": ROOT})
    check(out.returncode == 0, f"the serving process failed:\n"
          f"{out.stderr[-4000:]}")
    lines = out.stdout.strip().splitlines()
    return [json.loads(x) for x in lines[:-1]], json.loads(lines[-1])


def cpu_traced_export(path: str) -> float:
    """The flagship's step exported on the CPU (AOT_CPU_BATCH envs, for the
    CPU and the card) and saved at `path`: a run on the CPU alone, made by
    a worker (cpu_reference_calls); its seconds."""
    from rmp_tpu_torch.experiments import aot_export

    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    artifact, manifest, flat = aot_export.export_step(
        SCENE, AOT_CPU_BATCH, 1, platforms=["cpu", "cuda"], device="cpu")
    aot_export.save(path, artifact, manifest, flat)
    return time.perf_counter() - t0


@spent()
def eager_aot_rollout(geometry: str, batch: int, ticks: int,
                      tensor_gains: bool, device="cuda") -> tuple[list, float]:
    """(final state leaves, seconds) of the eager batched rollout the
    artifact was exported from, from the same reset, on the gains as 0-d
    tensors (what the artifact takes) or as Python numbers."""
    from rmp_tpu_torch.experiments import aot_export

    env = envs.make(SCENE, device=device)
    env.resolve_method = "solve"
    env.collision_geometry = geometry
    params = (aot_export.gains_as_tensors(env) if tensor_gains
              else env.gather_params())
    rollout = envs.make_batched_rollout(env, ticks, with_aux=False)
    warm = envs.make_batched_reset(env, batch)()
    envs.make_batched_rollout(env, 2, with_aux=False)(warm, params)
    states = envs.make_batched_reset(env, batch)()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, _ = rollout(states, params)
    torch.cuda.synchronize()
    return ([x.cpu() for x in aot_export._tensors(final)],
            time.perf_counter() - t0)


def visual_objs(directory: str) -> None:
    """The collision OBJs the asset tools read (MESH_OF_LINK's files),
    written from the visual meshes of assets/panda_visual.npz."""
    from rmp_tpu_torch.experiments.collision_mesh_error import MESH_OF_LINK

    data = np.load(os.path.join(ROOT, "assets", "panda_visual.npz"))
    for link, (fname, _) in MESH_OF_LINK.items():
        if link == "panda_rightfinger":   # the left finger's file, turned
            continue
        v = data[f"{link}_verts"].astype(np.float64)
        t = data[f"{link}_tris"] + 1
        with open(os.path.join(directory, fname), "w") as f:
            f.writelines(f"v {x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in v)
            f.writelines(f"f {a} {b} {c}\n" for a, b, c in t)


def tree_digest(directory: str) -> dict:
    """{relative path: sha256} of every file under a directory."""
    import hashlib

    out = {}
    for dirpath, _, names in os.walk(directory):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, ROOT)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


@spent()
def phase_asset_tools(card: str, device) -> dict:
    """fit_hulls (96 vertices, every link), fit_capsules (two links, 600
    steps a fit, on the card) and collision_mesh_error (4096
    configurations, the capsule tier) on OBJs written from the visual
    meshes; outputs into chiprun_out/assets15/; assets/ and reports/
    byte-identical after."""
    from rmp_tpu_torch.experiments import (collision_mesh_error,
                                           fit_capsules, fit_hulls)

    out_dir = os.path.join(ROOT, "chiprun_out", "assets15")
    os.makedirs(out_dir, exist_ok=True)
    before = {d: tree_digest(os.path.join(ROOT, d))
              for d in ("assets", "reports")}
    seconds = {}
    with tempfile.TemporaryDirectory() as meshes:
        visual_objs(meshes)
        t0 = time.perf_counter()
        check(fit_hulls.main(["--meshes", meshes, "--max-verts", "96",
                              "--out", os.path.join(out_dir,
                                                    "panda_hulls.npz")])
              == 0, "fit_hulls failed")
        seconds["fit_hulls"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        check(fit_capsules.main(["--meshes", meshes, "--steps", "600",
                                 "--links", "panda_link1,panda_hand",
                                 "--out", os.path.join(
                                     out_dir, "fit_capsules.json")]) == 0,
              "fit_capsules failed")
        seconds["fit_capsules"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        check(collision_mesh_error.main([
            "--configs", "4096", "--meshes", meshes, "--out",
            os.path.join(out_dir, "collision_mesh_error.json")]) == 0,
            "collision_mesh_error failed")
        seconds["collision_mesh_error"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, "hull_fit.json")) as f:
        hulls = json.load(f)
    with open(os.path.join(out_dir, "fit_capsules.json")) as f:
        caps = json.load(f)
    with open(os.path.join(out_dir, "collision_mesh_error.json")) as f:
        cme = json.load(f)
    check(len(hulls) == 10 and all(r["hull_verts"] <= 96
                                   for r in hulls.values()),
          "fit_hulls: a link missing or over 96 vertices")
    check(caps["device"].startswith("cuda"), "fit_capsules ran off the card")
    err = cme["obstacle_distance_error"]
    check(all(np.isfinite(v) for v in (err["overestimate_max_m"],
                                       err["mean_abs_m"])),
          "collision_mesh_error: non-finite errors")
    for d, digest in before.items():
        check(tree_digest(os.path.join(ROOT, d)) == digest,
              f"the asset tools changed {d}/")
    rec = dict(seconds=seconds,
               hull_support_error_mm={k: r["support_error_mm"]
                                      for k, r in hulls.items()},
               capsules={k: dict(k=r["k"], protrude_mm=r["protrude_mm"],
                                 bulge_mm=r["bulge_mm"],
                                 seconds=r["seconds"])
                         for k, r in caps["links"].items()},
               collision_mesh_error=err,
               collision_mesh_error_s=cme["seconds"])
    log(f"asset tools on the visual meshes: {json.dumps(rec)} [{card}]")
    return rec


def phase_slice15(card: str, device, eager_traces: dict) -> dict:
    """Phase 21: the compile probe (whose flagship artifact is the capsule
    one), the hull tier's export, a CPU-traced artifact, all three run in
    a fresh serving process against the eager rollouts, and the asset
    tools. eager_traces: phase 7's traces of the flagship's eager ticks,
    by tier."""
    from rmp_tpu_torch.experiments import aot_export, compile_probe
    from rmp_tpu_torch.ops import library

    t_start = time.perf_counter()
    os.makedirs(AOT_DIR, exist_ok=True)
    capsule = os.path.join(AOT_DIR, "flagship_capsule.pt2")
    # where phase 2 built the kernels from nothing in this process (a
    # checkout has no _build/), the probe reports that build, which is
    # its own _build.compile_into into a fresh directory
    with part("compile_probe"):
        probe = compile_probe.probe(SCENE, BATCH, device, capsule)
    log(f"compile_probe: {json.dumps(probe)} [{card}]")
    with open(os.path.join(ROOT, "chiprun_out", "compile_probe.json"),
              "w") as f:
        json.dump(probe, f, indent=2)
    want = {"capsule": set(library.OPS[:2]), "hull": set(library.OPS)}
    check(set(probe["export"]["ops"]) == want["capsule"],
          f"capsule artifact's ops {probe['export']['ops']}")
    t0 = time.perf_counter()
    hull = os.path.join(AOT_DIR, "flagship_hull.pt2")
    with part("hull export"):
        artifact, manifest, flat = aot_export.export_step(
            SCENE, BATCH, 1, device=device, geometry="hull")
        aot_export.save(hull, artifact, manifest, flat)
    hull_export_s = time.perf_counter() - t0
    hull_ops = manifest["ops"]
    check(set(hull_ops) == want["hull"], f"hull artifact's ops {hull_ops}")
    del artifact, flat
    # the CPU-traced artifact, exported by a CPU worker while the card ran
    cpu_traced = os.path.join(AOT_DIR, "flagship_cpu_traced.pt2")
    cpu_export_s = cpu_run(cpu_traced_export, cpu_traced)
    log(f"exports: hull {hull_export_s:.1f} s ({hull_ops}), "
        f"CPU-traced at {AOT_CPU_BATCH} envs {cpu_export_s:.1f} s (a CPU "
        f"worker's)")

    t0 = time.perf_counter()
    runs, modules = run_artifacts([(capsule, AOT_CALLS["capsule"]),
                                   (hull, AOT_CALLS["hull"]),
                                   (cpu_traced, AOT_CPU_CALLS)])
    serving_s = time.perf_counter() - t0
    check(not any(m.startswith("rmp_tpu_torch.envs") for m in modules),
          f"the serving process imported the scenes: {modules}")
    out = dict(probe=probe, hull_ops=hull_ops, hull_export_s=hull_export_s,
               cpu_export_s=cpu_export_s, serving_s=serving_s,
               serving_modules=modules, paths={})
    for geometry, rec in zip(("capsule", "hull"), runs):
        calls = AOT_CALLS[geometry]
        got = np.load(rec["path"] + ".final.npz")
        same, eager_s = eager_aot_rollout(geometry, BATCH, calls, True)
        equal = all(np.array_equal(got[f"arr_{i}"], x.numpy())
                    for i, x in enumerate(same))
        check(equal, f"{geometry} artifact: {calls} calls differ from the "
              f"eager rollout on the same gains")
        if geometry == "capsule":
            # the users' eager path takes the gains as Python numbers
            python, _ = eager_aot_rollout(geometry, BATCH, calls, False)
            rec["python_gains_max_abs_q"] = float(
                np.abs(got["arr_0"] - python[0].numpy()).max())
            check(rec["python_gains_max_abs_q"] < PARITY_ATOL,
                  f"capsule artifact: {calls} calls part from the eager "
                  f"rollout on Python-number gains by "
                  f"{rec['python_gains_max_abs_q']} (atol {PARITY_ATOL})")
        want_k = PATH_KERNELS[geometry]
        for name, count in rec["launches"].items():
            check(count == (calls if name in want_k else 0),
                  f"{geometry} artifact: {name} launched {count} times in "
                  f"{calls} calls")
        # eager's device kernels a tick: phase 7's trace of this tier (its
        # gains are Python numbers)
        rec.update(eager_seconds=eager_s,
                   eager_steps_per_s=BATCH * calls / eager_s,
                   eager_device_launches_per_tick=eager_traces[geometry][
                       "device_launches_per_tick"],
                   equal_to_eager=equal)
        log(f"{geometry} artifact, {calls} closed-loop calls in a serving "
            f"process: {json.dumps(rec)} [{card}]")
        out["paths"][geometry] = rec
    rec = runs[2]
    same, _ = eager_aot_rollout("capsule", AOT_CPU_BATCH, AOT_CPU_CALLS,
                                True)
    got = np.load(rec["path"] + ".final.npz")
    err = float(np.abs(got["arr_0"] - same[0].numpy()).max())
    check(err < PARITY_ATOL, f"CPU-traced artifact on the card: q parts "
          f"from the eager card run by {err}")
    for name in PATH_KERNELS["capsule"]:
        check(rec["launches"][name] == AOT_CPU_CALLS,
              f"CPU-traced artifact: {name} launched "
              f"{rec['launches'][name]} times")
    rec.update(max_abs_q_vs_eager_card=err)
    log(f"CPU-traced artifact moved to the card: {json.dumps(rec)} [{card}]")
    out["paths"]["cpu_traced"] = rec
    # the asset tools, which phase 19 ran beside its other untimed processes
    stdout, _ = ran("asset tools", asset_tools_cmd(card))
    lines = stdout.strip().splitlines()
    for line in lines[:-1]:
        log(line)
    out["assets"] = json.loads(lines[-1])
    out["seconds"] = time.perf_counter() - t_start
    log(f"phase 21: {out['seconds']:.1f} s")
    return out


# ------------------------------------------------ the eighteenth slice ----

K1_PIVOT_N = (10, 18, 32)      # tests/test_torch_pivot_cases.py's n
K1_TRANSPOSED_N = (18, 32)     # K1's backward solve on the warp kernel
# the warp kernel's time on each layout of PERF.md's targets: (phase
# record key, what), read from the phases that timed them
K1_TARGETS = (("n=12", "n = 12, random layout (phase 18)"),
              ("dual randomized", "n = 18, randomized dual real tick "
               "(phase 15)"),
              ("dual handover", "n = 18, handover real tick (phase 15)"),
              ("planar 24", "n = 24, planar real tick (phase 19)"),
              ("n=32", "n = 32, random layout (phase 18)"),
              ("planar 32", "n = 32, planar real tick (phase 19)"))


def k1_compare_nan(tags, blocks, what: str,
                   per_env: bool = False) -> tuple[float, float]:
    """K1 against its plain version where a NaN may reach q̈ (the 'nan'
    pivot case): the envs with a NaN in q̈ must be the same on both sides
    and compare as equal; every entry of every other env within K1_TOL x
    max(1, its own |q̈|), or with per_env (a singular case,
    resolve_cases.SINGULAR) within K1_TOL x max(1, its env's largest
    |q̈|). Returns (max |kernel - plain| over the envs held, its largest
    share of the limit)."""
    got = cuda_resolve.pullback_resolve_structured(tags, blocks)
    want = cuda_resolve.pullback_resolve_structured_plain(tags, blocks)
    torch.cuda.synchronize()
    nan_got, nan_want = torch.isnan(got).any(dim=1), torch.isnan(want).any(dim=1)
    g, w = got[~nan_want], want[~nan_want]
    mag = w.abs().amax(dim=1, keepdim=True) if per_env else w.abs()
    limit = K1_TOL * mag.clamp(min=1.0)
    diff = (g - w).abs()
    err = float(diff.max()) if w.numel() else 0.0
    worst = float((diff / limit).max()) if w.numel() else 0.0
    log(f"K1 {what}: max|kernel - plain| {err:.3e}, largest share of its "
        f"limit (K1_TOL x max(1, |q̈| of the {'env' if per_env else 'entry'}))"
        f" {worst:.3e}; NaN envs plain / kernel {int(nan_want.sum())} / "
        f"{int(nan_got.sum())}")
    check(bool(torch.equal(nan_got, nan_want)), f"K1 {what}: NaN envs part")
    check(bool(torch.isfinite(g).all()), f"K1 {what}: non-finite output")
    check(worst <= 1.0, f"K1 {what}: disagrees with plain version")
    return err, worst


def phase_slice18(card: str, device, timed: dict) -> dict:
    """Phase 22, K1's warp kernel (n = 10..32) redesigned for the H100:
    its build lines at every n (no spills); the pivot cases of
    rmp_tpu_torch/ops/resolve_cases.py (ties in a singular integer system,
    negative pivots, clamped tiny pivots, NaN) at n = 10, 18, 32, float32
    and bfloat16, B = 4096, 1, 7, 4093; the planar twelve-link arm's real
    tick at those batches; K1's backward solve (A through transposed
    strides) at n = 18 and 32; and the target layouts' times, which phases
    15, 18 and 19 took (`timed`), beside their bounds and half the bound."""
    t0 = time.perf_counter()
    builds = {n: ptxas_counts(K1_WIDE_SOURCE,
                              f"pullback_resolve_wide_kernelILi{n}E")
              for n in range(K1_LANE_N + 1, K1_EVERY_N[-1] + 1)}
    log(f"K1 warp kernel builds: {json.dumps(builds)}")
    err = 0.0
    for case in PIVOT_CASES:
        for n in K1_PIVOT_N:
            for B in (BATCH,) + RAGGED:
                tags, blocks = pivot_case(case, B, B, n)
                blocks = [tuple(torch.tensor(x, device=device) for x in blk)
                          for blk in blocks]
                half = [tuple(x.to(torch.bfloat16) for x in blk)
                        for blk in blocks]
                single = case in SINGULAR
                err = max(err, k1_compare_nan(tags, blocks,
                                              f"{case}, n={n}, B={B}",
                                              single)[0],
                          k1_compare_nan(tags, half,
                                         f"{case}, n={n}, B={B}, bfloat16",
                                         single)[0])
    env = planar.planar_arm_env(12)
    for B in (BATCH,) + RAGGED:
        err = max(err, k1_compare(*real_tick_blocks(env, B, 12),
                                  f"planar_12link (n=12) real tick, B={B}"))
    for n in K1_TRANSPOSED_N:
        for B in (BATCH,) + RAGGED:
            tags, blocks = k1_device_blocks(200 + n + B, B, n,
                                            K1_EVERY_N_LAYOUT, device)
            A, _ = cuda_resolve.assemble_structured(tags, blocks)
            g = torch.randn(B, n, generator=torch.Generator(
                device=device).manual_seed(n + B), device=device)
            got = cuda_resolve.transposed_solve(A, g, 0.0)
            want = cuda_resolve.pullback_resolve_structured_plain(
                ("identity",), [(A.transpose(-1, -2), g)])
            torch.cuda.synchronize()
            scale = max(1.0, float(want.abs().max()))
            e = _err(got, want)
            log(f"K1 transposed solve n={n}, B={B}: max|kernel - plain| "
                f"{e:.3e} (limit {K1_TOL * scale:.3e})")
            check(bool(torch.isfinite(got).all()) and e <= K1_TOL * scale,
                  f"K1 transposed solve n={n}, B={B}")
            err = max(err, e)
    targets = {}
    for key, what in K1_TARGETS:
        rec = timed.get(key)
        if rec is None:     # a run of chosen phases may lack it
            continue
        targets[what] = dict(
            device_ms=rec["device_ms"], bound_ms=rec["bound_ms"],
            half_bound_ms=2.0 * rec["bound_ms"],
            met_half_bound=rec["device_ms"] <= 2.0 * rec["bound_ms"])
        log(f"K1 target {what}: device {rec['device_ms']:.4f} ms, bound "
            f"{rec['bound_ms']:.6f} ms, goal (half the bound's rate) "
            f"{2.0 * rec['bound_ms']:.4f} ms [{card}]")
    for n, b in builds.items():
        check(b["registers"] is not None, f"K1 n={n}: no ptxas line")
        check(not b["spill_store_bytes"] and not b["spill_load_bytes"],
              f"K1 n={n}: registers spill ({b})")
    return dict(builds={str(k): v for k, v in builds.items()}, k1_err=err,
                targets=targets, seconds=time.perf_counter() - t0)


# ------------------------------------------ the twenty-first slice ----

PAST32_K1_N = (33, 36, 47, 48, 63, 64)   # K1's CTA kernel, both instantiations
PAST32_RAGGED = (7, 4093)
PAST32_LINKS = 64                  # the slice's arm: 65 frames, 64 motors
PAST32_TICKS = 10                  # its timed rollout at BATCH envs
PAST32_PARITY = (32, 3)            # (envs, ticks) of its GPU/CPU parity
PAST32_TRANSPOSED_N = 36           # K1's backward solve on the CTA kernel
K1_CTA_SOURCE = "pullback_resolve_cta.cuh"   # instantiated in two .cu
K1_CTA_KERNELS = {m: f"pullback_resolve_cta_kernelILi{m}E" for m in (40, 64)}
# the pivot cases (ops/resolve_cases.py) on the CTA kernel: n and envs
PAST32_PIVOT = ((40, 64), 1024)
K3_XL = ("fk_derivatives_xl.cu", "fk_derivatives_kernel_wideILi72ELi64ELi2E")
# the plain version's float32 q̈ within this share of K1_TOL of float64 (per
# env, relative to max(1, the env's largest |q̈|)): the envs held to K1_TOL
PAST32_SCREEN = 0.1


def four_pandas():
    """Four Pandas in one tree (make_multi_spec over PANDA_SPEC): 52 frames,
    36 motors."""
    return specs.build_model(specs.make_multi_spec(
        specs.PANDA_SPEC, ((0.0, 0.45, 0.0), (0.0, -0.45, 0.0),
                           (1.2, 0.45, 0.0), (1.2, -0.45, 0.0)),
        (0.0, 0.0, np.pi, np.pi), ("A_", "B_", "C_", "D_"),
        name="panda_x4"))


def past32_models() -> dict:
    """K3's models past the wide tile: the 33-link arm, four Pandas, the
    64-link arm of the path, the capacity (72 frames, 64 motors) and a
    branched tree past 32 motors."""
    return {"planar_33 (F=34, n=33)": planar_model(33),
            "four Pandas (F=52, n=36)": four_pandas(),
            "planar_64 (F=65, n=64)": planar_model(PAST32_LINKS),
            "planar_64 + 7 fixed (F=72, n=64)": fixed_tail_model(64, 7),
            "branched 40 + 8 (F=50, n=48)": branched_model(40, 8, 20)}


def k1_cta_residency(n: int, B: int = BATCH) -> dict:
    """The CTA kernel that takes n at B envs: its instantiation (kMaxN), the
    dynamic shared bytes a CTA (an env) and the envs an SM holds."""
    out = (ctypes.c_int * 3)()
    fn = _build.c_function("rmp_pullback_resolve_cta_residency",
                           [ctypes.c_int, ctypes.c_int,
                            ctypes.POINTER(ctypes.c_int)])
    check(fn(n, B, out) == 0, f"K1 CTA residency at n={n}")
    rec = dict(instantiation=out[2], dynamic_smem_bytes=out[0],
               envs_per_sm=out[1])
    log(f"K1 CTA kernel at n={n}, B={B}: {json.dumps(rec)}")
    check(rec["envs_per_sm"] > 0, f"K1 CTA kernel at n={n}: no env an SM")
    return rec


def k1_held(tags, blocks, what: str, got=None, want=None,
            exact=None) -> dict:
    """K1 against its plain version behind a float64 plain run: the envs
    whose float32 plain q̈ lies within PAST32_SCREEN x K1_TOL x max(1, the
    env's largest |q̈|) of float64 (at least half of them) are held to
    K1_TOL x max(1, |q̈|) entry by entry against the plain version; every
    env's backward error in float64 within K1_RESIDUAL. `want` and `exact`
    may come from a larger batch whose first envs these are."""
    if got is None:
        got = cuda_resolve.pullback_resolve_structured(tags, blocks)
    if want is None:
        want = cuda_resolve.pullback_resolve_structured_plain(tags, blocks)
    wide = [tuple(x.double() for x in blk) for blk in blocks]
    if exact is None:
        exact = cuda_resolve.pullback_resolve_structured_plain(tags, wide)
    A, f = cuda_resolve.assemble_structured(tags, wide)
    torch.cuda.synchronize()
    env_scale = exact.abs().amax(dim=1).clamp_min(1.0)
    plain_err = (want.double() - exact).abs().amax(dim=1) / env_scale
    keep = plain_err <= PAST32_SCREEN * K1_TOL
    limit = K1_TOL * want.abs().clamp_min(1.0)
    share = ((got - want).abs() / limit).amax(dim=1)
    x = got.double()
    r = (torch.einsum("bnm,bm->bn", A, x) - f).abs().amax(dim=1)
    backward = float((r / (A.abs().sum(dim=2).amax(dim=1)
                           * x.abs().amax(dim=1)
                           + f.abs().amax(dim=1))).max())
    rec = dict(envs=int(keep.numel()), held=int(keep.sum()),
               max_abs_err=float((got - want)[keep].abs().max())
               if bool(keep.any()) else 0.0,
               largest_share=float(share[keep].max()) if bool(keep.any())
               else 0.0, backward=backward)
    log(f"K1 {what}: {json.dumps(rec)} (held envs: K1_TOL x max(1, |q̈|) "
        f"against plain; backward limit {K1_RESIDUAL})")
    check(bool(torch.isfinite(got).all()), f"K1 {what}: non-finite output")
    check(2 * rec["held"] >= rec["envs"], f"K1 {what}: too few envs held")
    check(rec["largest_share"] <= 1.0,
          f"K1 {what}: disagrees with plain version")
    check(backward <= K1_RESIDUAL, f"K1 {what}: backward error")
    return rec


def phase_k1_past32(device) -> tuple[dict, float]:
    """K1's CTA kernel at every n of PAST32_K1_N on random blocks, float32
    and bfloat16, at B = BATCH and PAST32_RAGGED (the first envs of the
    BATCH blocks, against the same plain runs), behind k1_held's float64
    screen; the pivot cases at PAST32_PIVOT (k1_compare_nan; their largest
    share of the limit apart from the error returned); its backward
    solve at PAST32_TRANSPOSED_N; n = 65 raising before a launch."""
    err, out = 0.0, {}
    for n in PAST32_K1_N:
        tags, blocks = k1_device_blocks(400 + n, BATCH, n, K1_EVERY_N_LAYOUT,
                                        device)
        for dtype in (torch.float32, torch.bfloat16):
            cast = [tuple(x.to(dtype) for x in blk) for blk in blocks]
            want = cuda_resolve.pullback_resolve_structured_plain(tags, cast)
            exact = cuda_resolve.pullback_resolve_structured_plain(
                tags, [tuple(x.double() for x in blk) for blk in cast])
            for B in (BATCH,) + PAST32_RAGGED:
                part = [tuple(x[:B] for x in blk) for blk in cast]
                rec = k1_held(tags, part, f"n={n}, {str(dtype)[6:]}, B={B}",
                              want=want[:B], exact=exact[:B])
                out[f"n={n} {str(dtype)[6:]} B={B}"] = rec
                err = max(err, rec["max_abs_err"])
    # the pivot cases apart: a singular system's gap (q̈ near 1e11) would
    # hide the held layouts' error, so they give their largest share of
    # the limit
    pivot_n, B = PAST32_PIVOT
    share = 0.0
    for case in PIVOT_CASES:
        for n in pivot_n:
            tags, blocks = pivot_case(case, B, B, n)
            blocks = [tuple(torch.tensor(x, device=device) for x in blk)
                      for blk in blocks]
            half = [tuple(x.to(torch.bfloat16) for x in blk)
                    for blk in blocks]
            single = case in SINGULAR
            share = max(share, k1_compare_nan(
                tags, blocks, f"{case}, n={n}, B={B}", single)[1],
                k1_compare_nan(tags, half, f"{case}, n={n}, B={B}, bfloat16",
                               single)[1])
    out["pivot_largest_share"] = share
    log(f"K1 CTA kernel, pivot cases at n = {pivot_n}: largest share of the "
        f"limit {share:.3e} (apart from max_abs_err)")
    n = PAST32_TRANSPOSED_N
    for B in (BATCH,) + PAST32_RAGGED:
        tags, blocks = k1_device_blocks(500 + B, B, n, K1_EVERY_N_LAYOUT,
                                        device)
        A, _ = cuda_resolve.assemble_structured(tags, blocks)
        g = torch.randn(B, n, generator=torch.Generator(
            device=device).manual_seed(n + B), device=device)
        before = cuda_resolve.pullback_resolve_structured.transposed_launches
        got = cuda_resolve.transposed_solve(A, g, 0.0)
        check(cuda_resolve.pullback_resolve_structured.transposed_launches
              == before + 1, f"K1 transposed solve n={n}: not one launch")
        rec = k1_held(("identity",), [(A.transpose(-1, -2), g)],
                      f"transposed solve n={n}, B={B}", got=got)
        out[f"transposed n={n} B={B}"] = rec
        err = max(err, rec["max_abs_err"])
    out["raised"] = k1_raises(*k1_device_blocks(65, 4, 65, K1_EVERY_N_LAYOUT,
                                                device), "n=65")
    return out, err


def k3_real_tick(env, device) -> float:
    """K3 on the env's perturbed reset states (q ± 0.1, q̇ ± 0.05) at
    BATCH, against its plain version at K3_ATOL x max(1, max |plain|)."""
    states = perturbed_states(env, BATCH, 5, 0.1, 0.05)
    q, qd = states.sim.q, states.sim.qd
    got = cuda_fk.fk_derivatives_batched(env.model, q, qd)
    want = fk_derivatives(env.model, q, qd)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, w in zip(("T16", "Td16", "J16", "c16"), got, want):
        e = float((g - w).abs().max())
        check(e <= K3_ATOL * max(1.0, float(w.abs().max())),
              f"K3 {env.name} real tick {name}: disagrees with plain version")
        err = max(err, e)
    log(f"K3 {env.name} real tick, B={BATCH}: max|kernel - plain| {err:.3e}")
    return err


def phase_slice21(card: str, device) -> dict:
    """Phase 23, models past 32 motors and 40 frames: the builds of K1's CTA
    kernel (n = 33..64) and of K3's instantiation at 72 frames and 64
    motors; K1 at PAST32_K1_N (phase_k1_past32); K3 on past32_models
    against its plain version, 73 frames and 65 motors raising before a
    launch; K1 and K3 on the 64-link arm's real tick; the times of both
    beside their bounds, the plain versions and, for K1, einsum +
    torch.linalg.solve at n = 33, 36 and 64; the 64-link arm's rollout at
    BATCH x PAST32_TICKS (K1 and K3 once a tick, a trace) and its GPU/CPU
    parity behind the float64 and one-ulp screens."""
    t_start = time.perf_counter()
    failed: list = []
    builds = {f"K1 n<={n}": build_counts(K1_CTA_SOURCE, f"K1 CTA {n}", kernel)
              for n, kernel in K1_CTA_KERNELS.items()}
    builds["K3 (72, 64, 2)"] = build_counts(K3_XL[0], "K3 (72, 64)",
                                           K3_XL[1])
    for what, b in builds.items():
        if b["spill_store_bytes"] or b["spill_load_bytes"]:
            log(f"{what}: registers spill ({json.dumps(b)})")
            check(not what.startswith("K1"), f"{what}: registers spill")
    residency = {n: k1_cta_residency(n) for n in (33, 36, 48, 64)}
    k1, k1_err = phase_k1_past32(device)
    k3_err = max(k3_check(m, what, device)
                 for what, m in past32_models().items())
    raised = {"65 motors": k3_raises(planar_model(65), "66 frames, 65 motors",
                                     device),
              "73 frames": k3_raises(fixed_tail_model(64, 8),
                                     "73 frames, 64 motors", device)}
    name = f"planar_{PAST32_LINKS}link"
    env = planar.planar_arm_env(PAST32_LINKS)
    k3_err = max(k3_err, k3_real_tick(env, device))
    for B in (BATCH,) + PAST32_RAGGED:
        tags, blocks = real_tick_blocks(env, B, PAST32_LINKS)
        k1_err = max(k1_err, k1_compare_conditioned(
            tags, blocks, f"{name} (n={PAST32_LINKS}) real tick, B={B}"))
    times = {}
    tags, blocks = real_tick_blocks(env, BATCH, PAST32_LINKS)

    def call():
        return cuda_resolve.pullback_resolve_structured(tags, blocks)
    per_call = device_launches(call, "pullback_resolve_cta_kernel",
                               f"K1 n={PAST32_LINKS}")
    check(per_call == 1, f"K1 n={PAST32_LINKS}: not one launch per call")
    times["K1 n=64"] = dict(k1_times(f"{name} real tick", tags, blocks),
                            device_launches_per_call=per_call,
                            **residency[64])
    times["K1 n=33"] = dict(k1_times(
        "planar_33link real tick", *real_tick_blocks(
            planar.planar_arm_env(33), BATCH, 33)), **residency[33])
    times["K1 n=36"] = dict(k1_times("n=36 (random layout)", *k1_device_blocks(
        36, BATCH, 36, K1_EVERY_N_LAYOUT, device)), **residency[36])
    for what, model in past32_models().items():
        if "branched" not in what:
            times[f"K3 {what}"] = k3_times(model, what, device)
    launches, res = rollout_path(
        card, env, name, PAST32_TICKS,
        ("pullback_resolve_structured", "fk_derivatives_batched"), failed)
    envs_n, ticks = PAST32_PARITY
    res["parity"] = gpu_cpu_parity(
        lambda dev: planar.planar_arm_env(PAST32_LINKS, dev), name,
        B=envs_n, ticks=ticks, ulp=True)
    seconds = time.perf_counter() - t_start
    log(f"phase 23: {seconds:.1f} s")
    check(not failed, "; ".join(failed))
    return dict(builds=builds, k1=k1, k1_err=k1_err, k3_err=k3_err,
                raised=raised, times=times, result=res, residency=residency,
                paths={name: (launches, res)}, seconds=seconds)


# the phases whose records a later phase reads
PHASE_NEEDS = {20: (7,), 21: (7, 8), 22: (15, 18, 19)}


def cpu_reference_calls() -> list:
    """(phase, fn, args, kwargs) of every CPU run the phases take through
    cpu_run, in the order they need them: each call as its phase makes
    it."""
    calls = [(9, parity_q, ("cpu", 0.1, 0.05), {}),
             (9, parity_q, ("cpu", 0.3, 0.5), {}),
             (9, parity_q, ("cpu", 0.3, 0.5), dict(ulp=True))]
    calls += [(10, parity_q, ("cpu", 0.1, 0.05), dict(geometry="hull", B=B))
              for B in (128, 8)]
    calls += [(11, parity_q, ("cpu", 0.1, 0.05), dict(scene=SCENE05))]

    def scenes(phase, runs):
        out = []
        for run in runs:
            scene, torque, geometry = (*run, "capsule")[:3]
            out += [(phase, parity_q, ("cpu", 0.1, 0.05), dict(
                geometry=geometry, scene=scene, method=None, torque=torque,
                solved=True)), (phase, witness_q, (scene, torque, geometry),
                                {})]
        return out
    calls += scenes(12, NEW_SCENE_RUNS)
    calls += scenes(13, [(s, False) for s in SCENES7])
    for iters in HULL_PARITY_ITERS:
        calls += [(13, parity_q, ("cpu", 0.1, 0.05),
                   dict(warm_iters=iters, **MOVING_HULL_KW)),
                  (13, parity_q, ("cpu", 0.1, 0.05),
                   dict(ulp=True, warm_iters=iters, **MOVING_HULL_KW)),
                  (13, parity_q, ("cpu", 0.1, 0.05),
                   dict(warm_iters=iters + 1, **MOVING_HULL_KW)),
                  (13, witness_q, (MOVING, False, "hull", iters), {})]
    randomized = [(14, (g, RANDOMIZED, PARITY_B, PARITY_TICKS, None, None))
                  for g in ("capsule", "hull")]
    randomized += [(15, (g, DUAL_RANDOMIZED, *DUAL_PARITY[g], None, None))
                   for g in ("capsule", "hull")]
    randomized += [(15, ("hull", DUAL_HANDOVER, *HANDOVER_HULL_PARITY,
                         (0.1, 0.05), None))]
    calls += [(phase, randomized_cpu_runs, args, {})
              for phase, args in randomized]
    calls += scenes(15, [(DUAL_HANDOVER, False),
                         ("franka/03_self_avoidance", False, "hull")])
    randomized = [("capsule", PROVOKE, *CONTACT_PARITY, None,
                   "provoke_start")]
    randomized += [("hull", scene, *HULL_MODEL_PARITY, (0.1, 0.05), None)
                   for scene in HULL_MODEL_SCENES]
    randomized += [("capsule", scene, B, ticks, None, None)
                   for scene, (B, ticks) in NEURAL_PARITY.items()]
    calls += [(16, randomized_cpu_runs, args, {}) for args in randomized]
    cpu = torch.device("cpu")
    for scene, geometry, method, fused, B, ticks in GRAD_SCENES:
        args = (scene, geometry, method, fused, B, ticks, cpu)
        calls += [(17, grad_case, args, {}),
                  (17, grad_case, args, dict(float64=True))]
    calls += [(21, cpu_traced_export,
               (os.path.join(AOT_DIR, "flagship_cpu_traced.pt2"),), {})]
    return calls


def chosen_phases(argv) -> set | None:
    """The phases named on the command line (`--phases 3,15,22`), with the
    phases they read; None (every phase) without arguments. Phases 1 and 2
    (the card and the build) always run."""
    if not argv:
        return None
    if len(argv) != 2 or argv[0] != "--phases":
        raise SystemExit("usage: python3 chip_smoke.py [--phases N,N,...]")
    chosen = {int(x) for x in argv[1].split(",")}
    for number in sorted(chosen, reverse=True):
        chosen.update(PHASE_NEEDS.get(number, ()))
    return chosen


def main(argv=None) -> int:
    chosen = chosen_phases(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    start = time.perf_counter()
    check(torch.cuda.device_count() == 1,
          f"needs one card, sees {torch.cuda.device_count()}")
    device = torch.device("cuda")

    def phase_card():
        cards = card_lines()
        log(f"card: {'; '.join(cards)}")
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.get_device_name(0)}")
        return cards[0]

    def phase_build():
        t0 = time.perf_counter()
        # K1's op on CPU blocks while nvcc runs: the process's first call
        # through the op imports its dispatch (torch._dynamo among it)
        warm = threading.Thread(target=warm_dispatch)
        warm.start()
        lib = _build.build()
        warm.join()
        seconds = time.perf_counter() - t0
        built = _build.build_times()
        log(f"build: {lib} in {seconds:.1f} s ({built.get('cpus')} CPUs, at "
            f"most {built.get('jobs')} nvcc at a time); seconds to "
            f"each source's end {json.dumps(built.get('nvcc_s', {}))}")
        for line in _build.build_log().splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                log(f"  {line.strip()}")
        return seconds

    card = run_phase(1, start, phase_card)
    build_s = run_phase(2, start, phase_build)
    start_cpu_runs([call[1:] for call in cpu_reference_calls()
                    if chosen is None or call[0] in chosen])
    try:
        return run_phases(card, build_s, chosen, start, device)
    finally:
        stop_cpu_runs()


def run_phases(card: str, build_s: float, chosen: set | None, start: float,
               device) -> int:
    """Phases 3 on (main's, after the card and the build), the result
    lines."""
    env = envs.make(SCENE)
    out = {}

    def phase(number: int, fn, *args):
        if chosen is None or number in chosen:
            out[number] = run_phase(number, start, fn, *args)
        return out.get(number)

    slice14 = slice15 = slice18 = None
    k1 = phase(3, phase_k1, env, device)
    k2a, k2b = phase(4, phase_k2, device) or (None, None)
    k3 = phase(5, phase_k3, device)
    k4 = phase(6, phase_k4, env, device)
    launches, main_path = phase(7, phase_main_path, card, "capsule") or (
        None, None)
    hull_launches, hull_path = phase(8, phase_main_path, card, "hull") or (
        None, None)
    parity = phase(9, phase_parity)
    hull_parity = phase(10, phase_hull_parity)
    k5, scene05_parity = phase(11, lambda: (
        phase_k5(device), phase_scene05_parity())) or (None, None)
    slice6 = phase(12, phase_slice6, card, device)
    slice7 = phase(13, phase_slice7, card, device)
    slice8 = phase(14, phase_slice8, card, device)
    slice9 = phase(15, phase_slice9, card, device)
    slice10 = phase(16, phase_slice10, card, device)
    slice11 = phase(17, phase_slice11, card, device)
    slice12 = phase(18, phase_slice12, card, device)
    slice13 = phase(19, phase_slice13, card, device)
    if main_path is not None:
        slice14 = phase(20, phase_slice14, card, device, main_path["trace"])
    if hull_path is not None:
        slice15 = phase(21, phase_slice15, card, device,
                        {"capsule": main_path["trace"],
                         "hull": hull_path["trace"]})
    if slice9 is not None and slice12 is not None and slice13 is not None:
        slice18 = phase(22, phase_slice18, card, device, {
            "n=12": slice12["k1"]["times"]["n=12"],
            "n=32": slice12["k1"]["times"]["n=32"],
            "dual randomized": slice9["k1"]["dual randomized"],
            "dual handover": slice9["k1"]["dual handover"],
            "planar 24": slice13["k1"]["n=24"],
            "planar 32": slice13["k1"]["n=32"]})
    slice21 = phase(23, phase_slice21, card, device)
    if chosen is not None:
        log(f"phases (s): {json.dumps({str(k): round(v, 1) for k, v in PHASE_S.items()})}"
            f"; a run of chosen phases prints no result line")
        return 0
    k5_s, slice6_s, slice7_s, slice8_s, slice9_s, slice10_s, slice11_s = (
        PHASE_S[i] for i in range(11, 18))

    k1["per_layout"] = dict(flagship=dict(n=9, ms=k1["ms"],
                                          device_ms=k1["device_ms"]),
                            **slice6["k1"], **slice7["k1"], **slice8["k1"])
    k1["max_abs_err"] = max(k1["max_abs_err"], slice6["k1_err"],
                            slice7["k1_err"], slice8["k1_err"])
    k4["moving_obstacles_operands"] = slice7["k4"]
    k4["randomized_operands"] = slice8["k4"]
    k4["max_abs_err"] = max(k4["max_abs_err"], slice7["k4"]["dist_max"],
                            slice8["k4"]["dist_max"])
    k3["per_model"] = dict(panda=dict(frames=12, n=9, ms=k3["ms"],
                                      device_ms=k3["device_ms"]),
                           **slice6["k3"])
    k3["max_abs_err"] = max(k3["max_abs_err"], slice6["k3_err"])
    k4["dual_randomized_operands"] = slice9["k4"]
    k4["max_abs_err"] = max(k4["max_abs_err"], slice9["k4"]["dist_max"])
    k1_dual = dict(name="pullback_resolve_structured (n=18)", route="cuda",
                   source=f"rmp_tpu_torch/csrc/{K1_WIDE_SOURCE}",
                   replaces="rmp_tpu/ops/pallas_resolve.py:226",
                   max_abs_err=slice9["k1_err"], build=slice9["k1_build"],
                   per_layout=slice9["k1"], counter=k1["name"], dual=True,
                   **{k: slice9["k1"]["dual randomized"][k] for k in
                      ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                       "library_ms", "device_launches_per_call")})
    k3_dual = dict(name="fk_derivatives_batched (dual-arm Panda)",
                   route="cuda",
                   source="rmp_tpu_torch/csrc/fk_derivatives.cu",
                   replaces="rmp_tpu/ops/pallas_fk.py:218",
                   max_abs_err=slice9["k3_err"], library_ms=None,
                   counter=k3["name"], dual=True,
                   build=dict(k3["build"], dynamic_smem_bytes=slice9["k3"][
                       "dynamic_smem_bytes"]),
                   **{k: slice9["k3"][k] for k in
                      ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                       "device_launches_per_call", "panda_device_ms")})
    k1["dual"] = k3["dual"] = False
    path_launches = {"capsule": launches, "hull": hull_launches}
    for paths in (slice6["paths"], slice7["paths"], slice8["paths"],
                  slice9["paths"], slice10["paths"], slice12["paths"],
                  slice13["paths"], slice21["paths"]):
        path_launches.update((scene, counts) for scene, (counts, _) in
                             paths.items())
    # the eleventh slice's gradient and training paths
    path_launches.update(slice11["paths"])
    # the fifteenth slice's exported steps, run by a serving process
    for name, rec in slice15["paths"].items():
        path_launches[f"aot_export {SCENE} {name}"] = {
            counter: rec["launches"].get(counter, 0) for counter in COUNTERS}
    # the tenth slice's entries: each kernel on its new path, with that
    # path's launch count
    k3_contact = dict(name=f"fk_derivatives_batched ({PROVOKE} contact)",
                      route="cuda",
                      source="rmp_tpu_torch/csrc/fk_derivatives.cu",
                      replaces="rmp_tpu/ops/pallas_fk.py:218",
                      counter=k3["name"], path=PROVOKE, **slice10["k3"])
    k1_neural = dict(name=f"pullback_resolve_structured ({NEURAL_CLUTTER})",
                     route="cuda",
                     source="rmp_tpu_torch/csrc/pullback_resolve.cu",
                     replaces="rmp_tpu/ops/pallas_resolve.py:226",
                     counter=k1["name"], path=NEURAL_CLUTTER,
                     max_abs_err=slice10["k1_err"],
                     per_layout=slice10["k1"],
                     **{k: slice10["k1"]["neural_clutter"][k] for k in
                        ("ms", "device_ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms",
                         "device_launches_per_call")})
    k4_models = [dict(name=f"gjk_hull_obstacles ({rec['table']} table)",
                      route="cuda", source="rmp_tpu_torch/csrc/gjk_hull.cu",
                      replaces="rmp_tpu/ops/pallas_gjk.py:318",
                      counter=k4["name"], path=f"{scene} (hull)",
                      max_abs_err=rec["dist_max"], library_ms=None,
                      operands=rec, **{k: rec[k] for k in
                                       ("ms", "device_ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "device_launches_per_call")})
                 for scene, rec in slice10["k4"].items()]
    # the eleventh slice's entry: K1's kernel on the transposed system of
    # the resolve's backward, with the launches of tune_gains' gradient
    # through franka/06's batched 'solve' rollout (capsule tier)
    grad_path = f"tune_gains {SCENE} (capsule, 'solve', batched)"
    ts = slice11["k1"]["transposed"]
    k1_backward_rec = dict(
        name="pullback_resolve_structured (backward: transposed solve)",
        route="cuda", source="rmp_tpu_torch/csrc/pullback_resolve.cu",
        replaces="rmp_tpu/ops/pallas_resolve.py:226",
        counter="pullback_resolve_structured (transposed)", path=grad_path,
        max_abs_err=ts["max_abs_err"], ms=ts["device_ms"],
        device_ms=ts["device_ms"], plain_ms=ts["plain_ms"],
        bound_ms=ts["bound_ms"], bound_by=ts["bound_by"],
        library_ms=ts["library_ms"])
    # the twelfth slice's entries: K1 at the planar arms' n (the lane
    # kernel at 5, the warp kernel at 12) and on the flagship's bf16
    # blocks, each with its path's launches; K5 at n = 5 and 12 (no path)
    k2a["max_abs_err"] = max(k2a["max_abs_err"], slice12["k2a_err"])
    k2b["max_abs_err"] = max(k2b["max_abs_err"], slice12["k2b_err"])
    k1_times = slice12["k1"]["times"]
    k1_slice12 = [
        dict(name=f"pullback_resolve_structured ({label})", route="cuda",
             source="rmp_tpu_torch/csrc/" + (
                 K1_WIDE_SOURCE if "warp kernel" in label
                 else "pullback_resolve.cu"),
             replaces="rmp_tpu/ops/pallas_resolve.py:226",
             counter=k1["name"], path=path, max_abs_err=slice12["k1_err"],
             **{k: k1_times[key][k] for k in
                ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")})
        for label, key, path in (
            ("n=5, random layout", "n=5", "planar_5link"),
            ("n=12, warp kernel, random layout", "n=12", "planar_12link"),
            ("flagship, bfloat16 blocks", "flagship bf16", f"{SCENE} bf16"))]
    k5_slice12 = [
        dict(name=f"fused_qdd ({key})", route="cuda",
             source="rmp_tpu_torch/csrc/fused_tick.cu",
             replaces="rmp_tpu/ops/pallas_tick.py:421", counter=k5["name"],
             max_abs_err=slice12["k5_err"],
             **{k: rec[k] for k in ("ms", "device_ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "device_launches_per_call")})
        for key, rec in slice12["k5"].items()]
    # the thirteenth slice's entries: K3's wide instantiation and K1's warp
    # kernel at n = 24 and 32 on the planar arms' real ticks, each with its
    # path's launches
    k3_wide = [
        dict(name=f"fk_derivatives_batched (planar_{n}link, wide tile)",
             route="cuda",
             source="rmp_tpu_torch/csrc/fk_derivatives_wide.cuh",
             replaces="rmp_tpu/ops/pallas_fk.py:218", counter=k3["name"],
             path=f"planar_{n}link", max_abs_err=slice13["k3_err"],
             **{k: rec[k] for k in ("ms", "device_ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "device_launches_per_call", "frames",
                                    "tile_envs", "dynamic_smem_bytes",
                                    "envs_per_sm")})
        for n, rec in ((n, slice13["k3"]["times"][f"planar_{n}"])
                       for n in WIDE_LINKS)]
    k1_wide = [
        dict(name=f"pullback_resolve_structured (n={n}, planar real tick)",
             route="cuda", source=f"rmp_tpu_torch/csrc/{K1_WIDE_SOURCE}",
             replaces="rmp_tpu/ops/pallas_resolve.py:226",
             counter=k1["name"], path=f"planar_{n}link",
             max_abs_err=slice13["k1_err"],
             **{k: rec[k] for k in ("ms", "device_ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "device_launches_per_call")})
        for n, rec in ((n, slice13["k1"][f"n={n}"]) for n in WIDE_LINKS)]
    # the fourteenth slice's entries: K5's wide kernel at the 24- and
    # 32-link arms (no path runs K5)
    k5_wide = [
        dict(name=f"fused_qdd (planar_{n}link, wide kernel)", route="cuda",
             source="rmp_tpu_torch/csrc/fused_tick_wide.cuh",
             replaces="rmp_tpu/ops/pallas_tick.py:421", counter=k5["name"],
             max_abs_err=slice14["k5_err"],
             **{k: rec[k] for k in ("ms", "device_ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "device_launches_per_call",
                                    "dynamic_smem_bytes", "envs_per_sm")})
        for n, rec in ((n, slice14["k5"][f"planar_{n}"])
                       for n in K5_WIDE_LINKS[1:])]
    # the twenty-first slice's entries: K1's CTA kernel and K3's
    # instantiation at (72, 64) on the 64-link arm's path
    path64 = f"planar_{PAST32_LINKS}link"
    k1_cta = dict(
        name=f"pullback_resolve_structured (n={PAST32_LINKS}, CTA kernel, "
        f"{path64} real tick)", route="cuda",
        source="rmp_tpu_torch/csrc/pullback_resolve_cta.cuh",
        replaces="rmp_tpu/ops/pallas_resolve.py:226", counter=k1["name"],
        path=path64, max_abs_err=slice21["k1_err"],
        pivot_largest_share=slice21["k1"]["pivot_largest_share"],
        **{k: slice21["times"]["K1 n=64"][k] for k in
           ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_launches_per_call")})
    k3_xl = dict(
        name=f"fk_derivatives_batched ({path64}, 72-frame 64-motor tile)",
        route="cuda", source="rmp_tpu_torch/csrc/fk_derivatives_wide.cuh",
        replaces="rmp_tpu/ops/pallas_fk.py:218", counter=k3["name"],
        path=path64, max_abs_err=slice21["k3_err"],
        **{k: slice21["times"]["K3 planar_64 (F=65, n=64)"][k] for k in
           ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_launches_per_call", "frames", "tile_envs",
            "dynamic_smem_bytes", "envs_per_sm")})
    kernels = [k1, k2a, k2b, k3, k4, k5, k1_dual, k3_dual, k3_contact,
               k1_neural] + k4_models + [k1_backward_rec] + k1_slice12 \
        + k5_slice12 + k3_wide + k1_wide + k5_wide + [k1_cta, k3_xl]
    for rec in kernels:
        # each kernel's count from the paths that run it (K2a/K2b, K5:
        # none); K1 and K3 on the dual-arm Panda (n = 18, F = 26) apart
        # from their single-arm entries; a tenth-slice entry from its path
        counter = rec.pop("counter", rec["name"])
        dual = rec.pop("dual", None)
        path = rec.pop("path", None)
        own = ({path: path_launches[path]} if path is not None else
               {p: c for p, c in path_launches.items()
                if dual is None or ("dual_panda" in p) == dual})
        rec["launches"] = max(c[counter] for c in own.values())
        for name, counts in own.items():
            rec[f"launches_{name}_path"] = counts[counter]
    record = dict(card=card, torch=torch.__version__, build_s=build_s,
                  kernels=kernels, main_path=main_path, hull_path=hull_path,
                  parity=parity, hull_parity=hull_parity,
                  scene05_parity=scene05_parity, phase11_s=k5_s,
                  ur5_paths={scene: path for scene, (_, path) in
                             slice6["paths"].items()},
                  new_scene_parity=slice6["parity"],
                  rmpcore_goldens=slice6["goldens"], phase12_s=slice6_s,
                  slice7_paths={scene: path for scene, (_, path) in
                                slice7["paths"].items()},
                  slice7_pinv=slice7["pinv"],
                  slice7_parity=slice7["parity"],
                  slice7_hull_parity=slice7["hull_parity"],
                  ik_start=slice7["ik_start"],
                  simulation=slice7["simulation"], phase13_s=slice7_s,
                  slice8_paths={scene: path for scene, (_, path) in
                                slice8["paths"].items()},
                  slice8_parity=slice8["parity"], phase14_s=slice8_s,
                  slice9_paths={scene: path for scene, (_, path) in
                                slice9["paths"].items()},
                  slice9_parity=slice9["parity"],
                  dual_golden=slice9["golden"], phase15_s=slice9_s,
                  slice10_paths={scene: path for scene, (_, path) in
                                 slice10["paths"].items()},
                  slice10_parity=slice10["parity"],
                  impulse=slice10["impulse"],
                  phase16_parts_s=slice10["seconds"], phase16_s=slice10_s,
                  slice11=slice11, phase17_s=slice11_s,
                  slice12={k: v for k, v in slice12.items() if k != "paths"},
                  slice13={k: v for k, v in slice13.items() if k != "paths"},
                  slice14=slice14, slice15=slice15,
                  slice18=slice18,
                  slice21={k: v for k, v in slice21.items() if k != "paths"},
                  phase_s={str(k): v for k, v in PHASE_S.items()},
                  spent_s=SPENT, trace_tries=TRACE_TRIES)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    log(f"phases (s): {json.dumps({str(k): round(v, 1) for k, v in PHASE_S.items()})}; "
        f"whole run {time.perf_counter() - start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
