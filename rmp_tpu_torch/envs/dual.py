"""Dual-arm scenes: two Panda arms on one kinematic tree (the dual-arm Panda
of models/robots.dual_panda, 18 motors).

The port's `rmp_tpu/envs/dual.py`, batched:

dual_panda/handover: the arms face each other (bases 0.9 m apart) and take
turns at a shared centre point; each time both EEs reach their targets the
turn swaps in-graph (HANDOVER_PHASES through take_row), while one v1
collision-avoidance policy per distal left link, fed by the inter-arm
closest points (capsule, or hull against hull), keeps them apart.

dual_panda/randomized_clutter: every env draws its own cylinders in the
shared workspace (clear of the posed links), jittered start poses and
per-arm goals clear of the obstacles and of each other. Per-arm progress
counters in EnvState.scratch drive yielding (the arm farther from its goal
retreats to its side station when the arms contest a region), solo detours,
a final push and per-arm goal reassignment; obstacle avoidance is split per
arm so a push relaxes only the pushing arm's barrier.

Scenes draw from EnvState.stream (a torch.Generator on the envs' device)
for every env at every tick and keep the draws where they apply, so a
tick never waits on the host; jax.random streams are not reproduced.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rmp_tpu_torch import taskmaps as tm
from rmp_tpu_torch.envs import maneuver as mv
from rmp_tpu_torch.envs.base import Env, EnvState, env_state, take_row
from rmp_tpu_torch.envs.franka import (_obstacle_policies, bucket_capacity,
                                       self_pair_context)
from rmp_tpu_torch.models import kinematics as K
from rmp_tpu_torch.models import robots
from rmp_tpu_torch.policies import v1, v2
from rmp_tpu_torch.sim import randomizer as rnd
from rmp_tpu_torch.sim.collision import (ObstacleSet, link_world_capsules_all,
                                         pad_obstacles)
from rmp_tpu_torch.sim.data import PAIRS_KEY, distance_context
from rmp_tpu_torch.sim.world import SimState, init_state

EE_L = "L_panda_grasptarget_hand"
EE_R = "R_panda_grasptarget_hand"
# distal links that can meet in the shared workspace
_DISTAL = ("panda_link4", "panda_link5", "panda_link6", "panda_link7",
           "panda_hand")

# the turns of the handover: phase even, L at the centre and R at its side
# station; phase odd, R at the centre and L at its side station
_CENTER_L = (0.30, 0.00, 0.47)
_CENTER_R = (0.30, 0.00, 0.40)
_SIDE_L = (0.35, 0.30, 0.45)
_SIDE_R = (0.35, -0.30, 0.45)
HANDOVER_PHASES = np.asarray([[_CENTER_L, _SIDE_R],
                              [_SIDE_L, _CENTER_R]], np.float32)

# the randomized scene's shared workspace between the bases (y = ±0.45):
# obstacles spawn in the contested middle; each arm's goals favour its own
# half and overlap the centre
OBS_BOX = ((0.10, -0.28, 0.15), (0.50, 0.28, 0.85))
GOAL_BOX_L = ((0.15, -0.05, 0.30), (0.50, 0.30, 0.65))
GOAL_BOX_R = ((0.15, -0.30, 0.30), (0.50, 0.05, 0.65))
# retreat stations, each arm's own side past the obstacle box (|y| > 0.28)
STATION = np.asarray([[0.30, 0.35, 0.55],
                      [0.30, -0.35, 0.55]], np.float32)
# the per-env knobs of the randomized scene (EnvState.scratch['cfg']), the
# JAX package's defaults (rmp_tpu/envs/dual.py:314-392 gives the sweeps
# behind each)
CFG = dict(
    man_first_only=1.0,   # maneuvers only before the first goal event
    man_arrive=1.0,       # a maneuver ends within 8 cm of its waypoint
    yield_radius=0.30,    # m, EE-EE distance that counts as contested
    yield_trigger=25.0,   # stalled ticks before the farther arm yields
    esc_trigger=40.0,     # stalled ticks before a solo obstacle detour
    man_ticks=30.0,       # yield / detour duration
    timeout=80.0,         # stalled ticks before the arm's goal resamples
    timeout_spent=50.0,   # ... once the arm's maneuver budget is spent
    man_budget_late=0.0,  # maneuvers per arm per later goal
    man_budget=2.0,       # maneuvers per arm per goal
    hold_tol=0.035,       # an arm this near its goal never stalls
    push_first_only=0.0,  # 1: the final push only before the first event
    push_trigger=20.0,    # final push on a stall of this many ticks ...
    push_near=0.08,       # ... within this many m of the goal
    push_boost=3.0,       # attractor gain scale in the push
    push_relax=2.0,       # the pushing arm's obstacle policy / this
    push_relax_global=0.0,  # 1: either arm's push relaxes both arms
    push_relax_metric=0.0,  # 1: relax the obstacle metric only
    hold_boost=1.0,       # >1: pin an arm within hold_radius of its goal
    hold_radius=0.05,     # m
    man_relax=4.0,        # the maneuvering arm's obstacle metric / this
    obs_margin=0.0,       # m added to both arms' obstacle margins
    man_scored=0.0,       # 1: the retreat waypoint of 4 scored candidates
)
ARRIVE_TOL = 0.08         # m: a maneuver within this of its waypoint ends
JITTER = 0.12             # m: the station waypoint's uniform jitter
SIDE_Y = (0.30, -0.30)    # each arm's own half, for the scored candidates
GOAL_BLOCK_R = 0.12       # m: a goal clears the other arm's goal by this


def _ee_taskmap(model, frame):
    return tm.chain(tm.fk_frame(model, frame), tm.to_position())


def _distal_frames(model, prefix):
    return [i for i in model.collision_frames
            if model.link_names[i].startswith(prefix)
            and model.link_names[i][2:] in _DISTAL]


def _inter_arm_policies(model, device):
    """(policies, left frames, cross pairs, rows): one v1 collision
    avoidance per distal L collision frame over its L x R closest-point
    pairs, reading the context entry 'inter_arm:<frame>'; rows maps each
    left frame to the device long tensor of its pairs' rows."""
    left, right = _distal_frames(model, "L_"), _distal_frames(model, "R_")
    pairs = tuple((a, b) for a in left for b in right)
    policies = []
    for f in left:
        frame = model.frame_names[f]
        taskmap = tm.chain(tm.fk_frame(model, frame), tm.relative_points())
        pol = v1.collision_avoidance(
            taskmap=taskmap, eta_rep=0.1 * np.e, nu_rep=0.3, eta_damp=0.5,
            nu_damp=0.3, r=0.15, c=1e5, name=f"inter_arm_for_{frame}")
        pol.ctx_key = f"inter_arm:{frame}"
        policies.append(pol)
    rows = {f: torch.as_tensor([i for i, (a, _) in enumerate(pairs)
                                if a == f], dtype=torch.long, device=device)
            for f in left}
    return policies, left, pairs, rows


def _inter_arm_ctx(model, T_all, pairs, rows, hull: bool) -> dict:
    """The inter-arm context entries of T_all (B, F, 4, 4)."""
    return self_pair_context(
        model, T_all, pairs, rows,
        {f: f"inter_arm:{model.frame_names[f]}" for f in rows}, hull=hull)


def _attractor(model, goal, frame, p_gain, d_gain, name, device):
    return v2.target_attractor(
        goal=goal, taskmap=_ee_taskmap(model, frame), accel_p_gain=p_gain,
        accel_d_gain=d_gain, accel_norm_eps=0.075,
        metric_alpha_length_scale=0.05, min_metric_alpha=0.03,
        max_metric_scalar=1, min_metric_scalar=0.5,
        proximity_metric_boost_scalar=1.0,
        proximity_metric_boost_length_scale=0.02, name=name, device=device)


def arm_ee(model, q: torch.Tensor, frames) -> torch.Tensor:
    """World positions (B, 2, 3) of the two arms' EE frames at q (B, n):
    one pass of joint transforms, each frame's ancestor chain."""
    T_local = K.joint_transforms(model, q)
    out = []
    for f in frames:
        chain = model.chain(f)
        T = T_local[..., chain[0], :, :]
        for i in chain[1:]:
            T = T @ T_local[..., i, :, :]
        out.append(T[..., :3, 3])
    return torch.stack(out, dim=-2)


def env_handover(device) -> Env:
    """The alternating centre handover: per-arm v2 attractors, the velocity
    cap, damping and c-space bias, and the inter-arm avoidance; a joint
    solve advances the turn."""
    device = torch.device(device)
    model = robots.dual_panda(separation=0.9)
    q_ready = robots.dual_panda_q_ready(model)
    inter_arm, _, pairs, rows = _inter_arm_policies(model, device)
    policies = tuple([
        _attractor(model, HANDOVER_PHASES[0, 0], EE_L, 0.6, 0.9,
                   "attractor_L", device),
        _attractor(model, HANDOVER_PHASES[0, 1], EE_R, 0.6, 0.9,
                   "attractor_R", device),
        v2.joint_velocity_cap(max_velocity=1.0, velocity_damping_region=0.15,
                              damping_gain=5.0, metric_weight=0.05),
        v2.joint_damping(accel_d_gain=1, metric_scalar=0.005, inertia=0.3),
        v2.cspace_biasing(goal=q_ready, metric_scalar=0.005, position_gain=1,
                          damping_gain=2, robust_position_term_thresh=0.5,
                          inertia=0.0001, device=device),
    ] + inter_arm)
    phases = torch.as_tensor(HANDOVER_PHASES, device=device)
    ees = (model.frame_index(EE_L), model.frame_index(EE_R))

    def context_fn(model_, sim, T_all=None):
        if T_all is None:
            T_all = K.fk_all(model_, sim.q)
        return _inter_arm_ctx(model_, T_all, pairs, rows,
                              env.collision_geometry == "hull")

    def bind_params(params, sim, pols):
        out = []
        for p, prm in zip(pols, params):
            if p.name == "attractor_L":
                prm = dict(prm, goal=sim.goal[:, 0])
            elif p.name == "attractor_R":
                prm = dict(prm, goal=sim.goal[:, 1])
            out.append(prm)
        return tuple(out)

    def is_solved_fn(env_, sim):
        d = torch.linalg.vector_norm(arm_ee(model, sim.q, ees) - sim.goal,
                                     dim=-1)
        return (d < env_.solved_tol).all(dim=-1)

    def on_solved(state: EnvState) -> EnvState:
        # the turn swaps: the centre arm retreats, the other takes over
        nxt = state.phase + 1
        sim = dataclasses.replace(state.sim, goal=take_row(phases, nxt % 2))
        return dataclasses.replace(state, sim=sim, phase=nxt)

    def reset(batch: int, seed: int = 0) -> EnvState:
        return env_state(init_state(model, batch, device, q=q_ready,
                                    goal=HANDOVER_PHASES[0]), seed)

    # context_fn reads the env, so setting env.collision_geometry after
    # construction switches the inter-arm queries too
    env = Env(name="dual_panda/handover", model=model, policies=policies,
              reset=reset, ee_frame=ees[0], device=device, solved_tol=0.03,
              bind_params=bind_params, is_solved_fn=is_solved_fn,
              context_fn=context_fn, on_solved=on_solved,
              resolve_method="solve", max_qdd=1000.0)
    return env


def dual_scratch(batch: int, device) -> dict:
    """EnvState.scratch of the randomized dual scene: per-arm (B, 2)
    maneuver timers and counts, waypoints (B, 2, 3), stall counters, best
    and current goal distances, and the knobs of CFG."""
    z2 = torch.zeros(batch, 2, dtype=torch.int32, device=device)
    inf2 = torch.full((batch, 2), float("inf"), device=device)
    return dict(man_ticks=z2, man_count=z2.clone(),
                wp=torch.zeros(batch, 2, 3, device=device),
                noprog=z2.clone(), best=inf2, d=inf2.clone(),
                cfg=mv.cfg_scratch(CFG, batch, device))


def with_goal_blocked(obstacles: ObstacleSet, goal: torch.Tensor,
                      r: float = GOAL_BLOCK_R) -> ObstacleSet:
    """The env's obstacles (B, K, ...) and a phantom sphere of radius r at
    goal (B, 3): a new goal of one arm keeps clear of the other arm's."""
    B = goal.shape[0]
    return ObstacleSet(
        p0=torch.cat([obstacles.p0, goal[:, None]], dim=1),
        p1=torch.cat([obstacles.p1, goal[:, None]], dim=1),
        radius=torch.cat([obstacles.radius,
                          torch.full((B, 1), r, dtype=goal.dtype,
                                     device=goal.device)], dim=1),
        kinds=((obstacles.kinds or ("capsule",) * obstacles.count)
               + ("capsule",)))


def sample_goals(gen, obstacles: ObstacleSet,
                 prev: torch.Tensor | None = None,
                 resample: torch.Tensor | None = None) -> torch.Tensor:
    """Goals (B, 2, 3) from the arms' boxes for the envs' obstacles: both
    fresh (prev None), or fresh where resample (B, 2) and prev kept
    elsewhere. L draws first; each new goal clears the obstacles and the
    other arm's goal (kept, or just drawn)."""
    B = obstacles.p0.shape[0]
    if prev is None:
        gL = rnd.randomize_goal_box(gen, B, *GOAL_BOX_L, obstacles=obstacles)
        gR = rnd.randomize_goal_box(gen, B, *GOAL_BOX_R,
                                    obstacles=with_goal_blocked(obstacles,
                                                                gL))
        return torch.stack([gL, gR], dim=1)
    gL = torch.where(resample[:, :1], rnd.randomize_goal_box(
        gen, B, *GOAL_BOX_L,
        obstacles=with_goal_blocked(obstacles, prev[:, 1])), prev[:, 0])
    gR = torch.where(resample[:, 1:], rnd.randomize_goal_box(
        gen, B, *GOAL_BOX_R,
        obstacles=with_goal_blocked(obstacles, gL)), prev[:, 1])
    return torch.stack([gL, gR], dim=1)


def env_randomized_clutter(device, n_obstacles: int = 5,
                           obstacle_capacity: int | None = "auto") -> Env:
    """Domain-randomized dual-arm clutter (rmp_tpu/envs/dual.py:198-653).

    obstacle_capacity: the count every scene is padded to with inert far
    obstacles; "auto" takes the 8/16 bucket holding n_obstacles.

    Per tick, pre_tick keeps each arm's stall counter (an arm within
    hold_tol of its goal never stalls) and fires a maneuver: where the EEs
    are within yield_radius and either arm stalled yield_trigger ticks, the
    arm farther from its goal yields (ties to L); an uncontested arm
    stalled esc_trigger ticks detours. Either goes to its jittered side
    station (or the best of four scored candidates with man_scored) for
    man_ticks ticks, ending on arrival. The state-aware bind chases the
    waypoint, boosts a stalled near-goal arm's attractor (the final push)
    and relaxes that arm's obstacle policy. stuck_fn fires per arm on the
    stall window (spent_timeout) and on the global 120-tick backstop, and
    on_solved resamples only the timed-out arms' goals (both on a joint
    solve)."""
    device = torch.device(device)
    if obstacle_capacity == "auto":
        obstacle_capacity = bucket_capacity(n_obstacles)
    model = robots.dual_panda(separation=0.9)
    q_ready = robots.dual_panda_q_ready(model)
    inter_arm, _, pairs, rows = _inter_arm_policies(model, device)
    arm_rows = {p: [i for i, f in enumerate(model.collision_frames)
                    if model.frame_names[f].startswith(p)]
                for p in ("L_", "R_")}
    pairs_arm = {"L_": "__pairs_L__", "R_": "__pairs_R__"}
    arm_idx = {p: torch.as_tensor(r, dtype=torch.long, device=device)
               for p, r in arm_rows.items()}
    policies = tuple([
        _attractor(model, list(GOAL_BOX_L[0]), EE_L, 2.5, 1.5, "attractor_L",
                   device),
        _attractor(model, list(GOAL_BOX_R[0]), EE_R, 2.5, 1.5, "attractor_R",
                   device),
        v2.joint_velocity_cap(max_velocity=0.8, velocity_damping_region=0.15,
                              damping_gain=5.0, metric_weight=0.05),
        v2.joint_damping(accel_d_gain=1, metric_scalar=0.005, inertia=0.3),
        v2.cspace_biasing(goal=q_ready, metric_scalar=0.005, position_gain=1,
                          damping_gain=2, robust_position_term_thresh=0.5,
                          inertia=0.0001, device=device),
    ] + _obstacle_policies(
        model, frames=[model.collision_frames[i] for i in arm_rows["L_"]],
        name="collision_avoidance_L", ctx_key=pairs_arm["L_"])
      + _obstacle_policies(
        model, frames=[model.collision_frames[i] for i in arm_rows["R_"]],
        name="collision_avoidance_R", ctx_key=pairs_arm["R_"])
      + inter_arm)
    ees = (model.frame_index(EE_L), model.frame_index(EE_R))
    station = torch.as_tensor(STATION, device=device)
    # the scored candidates' offsets from the EE: a lift, and each arm's
    # own-side slides (B, 2, 3) broadcast
    f32 = dict(dtype=torch.float32, device=device)
    lift = torch.tensor([0.0, 0.0, 0.30], **f32)
    slide = torch.tensor([[0.0, y, 0.0] for y in SIDE_Y], **f32)
    slide_up = torch.tensor([[-0.15, y, 0.20] for y in SIDE_Y], **f32)
    space = rnd.RobotSampleSpace(
        q_low=q_ready - 0.1, q_high=q_ready + 0.1,
        qd_low=np.full_like(q_ready, -0.005),
        qd_high=np.full_like(q_ready, 0.005))

    def context_fn(model_, sim, T_all=None):
        if T_all is None:
            T_all = K.fk_all(model_, sim.q)
        ctx = distance_context(model_, T_all, sim.obstacles,
                               geometry=env.collision_geometry)
        # each arm's rows of the stacked (B, L, K, ...) pair context, for
        # the split obstacle policies
        for p in ("L_", "R_"):
            ctx[pairs_arm[p]] = {k: v.index_select(1, arm_idx[p])
                                 for k, v in ctx[PAIRS_KEY].items()}
        ctx.update(_inter_arm_ctx(model_, T_all, pairs, rows,
                                  env.collision_geometry == "hull"))
        return ctx

    def bind_params(params, sim, pols, state):
        sc = state.scratch
        cfg = sc["cfg"]

        def arm(x):                        # a per-env knob (B,) -> (B, 1)
            return x[:, None]
        maneuvering = sc["man_ticks"] > 0                        # (B, 2)
        eff = torch.where(maneuvering[..., None], sc["wp"], sim.goal)
        push = (~maneuvering
                & mv.push_engaged(cfg, sc["noprog"], sc["best"])
                & arm((cfg["push_first_only"] < 0.5) | (state.phase == 0)))
        boost = torch.where(push, arm(cfg["push_boost"]), 1.0)
        # hold-assist: pin an arm at its goal while the other finishes
        hold = sc["d"] < arm(cfg["hold_radius"])
        hboost = torch.where(hold, arm(cfg["hold_boost"]), 1.0)
        boost = boost * hboost
        # only the pushing arm's barrier yields (push_relax_global: both)
        push_any = torch.where(arm(cfg["push_relax_global"]) > 0.5,
                               push.any(dim=1, keepdim=True), push)
        relax = torch.where(push_any, arm(cfg["push_relax"]), 1.0)
        relax_rep = torch.where(arm(cfg["push_relax_metric"]) > 0.5,
                                torch.ones_like(relax), relax)
        # the maneuvering arm's metric-only relax (push needs ~maneuvering)
        mrelax = relax * torch.where(maneuvering, arm(cfg["man_relax"]), 1.0)
        out = []
        for p, prm in zip(pols, params):
            if p.name in ("collision_avoidance_L", "collision_avoidance_R"):
                a = int(p.name.endswith("R"))
                prm = mv.relaxed_obstacle(prm, relax_rep[:, a], mrelax[:, a])
                prm["margin"] = prm["margin"] + cfg["obs_margin"]
            elif p.name in ("attractor_L", "attractor_R"):
                a = int(p.name.endswith("R"))
                prm = mv.scaled_attractor(prm, goal=eff[:, a],
                                          gain_boost=boost[:, a],
                                          metric_scale=hboost[:, a])
            out.append(prm)
        return tuple(out)

    def pre_tick(state: EnvState) -> EnvState:
        """Per-arm stall bookkeeping, the yield and detour triggers, the
        waypoints and the maneuver timers, for every env."""
        sc = state.scratch
        cfg = sc["cfg"]
        sim = state.sim
        B = sim.q.shape[0]
        ee = arm_ee(model, sim.q, ees)                           # (B, 2, 3)
        d = torch.linalg.vector_norm(ee - sim.goal, dim=-1)      # (B, 2)

        improved = d < sc["best"] - 0.01
        best = torch.minimum(sc["best"], d)
        noprog = torch.where((d < cfg["hold_tol"][:, None]) | improved, 0,
                             sc["noprog"] + 1)
        free = mv.budget_free(cfg, sc["man_ticks"], sc["man_count"],
                              state.phase)
        contested = (torch.linalg.vector_norm(ee[:, 0] - ee[:, 1], dim=-1)
                     < cfg["yield_radius"])[:, None]             # (B, 1)
        stalled_y = noprog >= cfg["yield_trigger"][:, None]
        # the farther arm yields; exact ties go to L
        first = d[:, 0] >= d[:, 1]
        farther = torch.stack([first, ~first], dim=1)
        yield_t = (contested & stalled_y.any(dim=1, keepdim=True) & farther
                   & free)
        solo_t = ~contested & (noprog >= cfg["esc_trigger"][:, None]) & free
        trigger = yield_t | solo_t                               # (B, 2)

        # a jitter draw for every env each tick, used where a trigger fires
        u = rnd.uniform(state.stream, B, 2, 3, dtype=sim.q.dtype)
        wp_station = station + rnd.scale_uniform(u, -JITTER, JITTER)
        # scored candidates per arm: station, lift, own-side slides; the
        # clearance to the obstacles and to the other arm's EE
        cands = (wp_station, ee + lift, ee + slide, ee + slide_up)
        other = ee.flip(1)[:, :, None]                           # (B,2,1,3)
        best_c, _ = mv.score_candidates(
            cands, sim.goal,
            lambda c: mv.point_clearance(
                sim.obstacles, c,
                seed=torch.linalg.vector_norm(c - other, dim=-1) - 0.10))
        wp_new = torch.where((cfg["man_scored"] > 0.5)[:, None, None],
                             best_c, wp_station)
        any_t = trigger.any(dim=1)

        ticks_next, count_next, wp_next = mv.maneuver_timers(
            cfg, sc["man_ticks"], sc["man_count"], trigger, ee, sc["wp"],
            wp_new, arrive_tol=ARRIVE_TOL)
        scratch = dict(
            sc, man_ticks=ticks_next, man_count=count_next, wp=wp_next,
            # the stalled arm's window is frozen during its maneuver
            noprog=torch.where(trigger | (ticks_next > 0), 0, noprog),
            best=torch.where(trigger, float("inf"), best), d=d)
        # the global window (the backstop) does not fire mid-maneuver
        no_progress, goal_best = mv.freeze_progress(
            state, any_t, (ticks_next > 0).any(dim=1))
        return dataclasses.replace(state, scratch=scratch,
                                   no_progress=no_progress,
                                   goal_best=goal_best)

    def arm_distances(sim):
        return torch.linalg.vector_norm(arm_ee(model, sim.q, ees) - sim.goal,
                                        dim=-1)                  # (B, 2)

    def is_solved_fn(env_, sim):
        return (arm_distances(sim) < env_.solved_tol).all(dim=-1)

    def goal_distance_fn(env_, sim):
        # progress is the worse arm improving
        return arm_distances(sim).amax(dim=-1)

    def on_solved(state: EnvState) -> EnvState:
        """A joint solve or a per-arm timeout: new goals for the timed-out
        arms only (both on a solve or the backstop), their budgets and
        windows reset; phase records the tick."""
        sc = state.scratch
        timed_out = sc["noprog"] >= mv.spent_timeout(sc["cfg"],
                                                     sc["man_count"],
                                                     state.phase)
        resample = timed_out | ~timed_out.any(dim=1, keepdim=True)
        goals = sample_goals(state.stream, state.sim.obstacles,
                             prev=state.sim.goal, resample=resample)
        scratch = dict(
            sc,
            man_ticks=torch.where(resample, 0, sc["man_ticks"]),
            man_count=torch.where(resample, 0, sc["man_count"]),
            noprog=torch.where(resample, 0, sc["noprog"]),
            best=torch.where(resample, float("inf"), sc["best"]))
        return dataclasses.replace(
            state, sim=dataclasses.replace(state.sim, goal=goals),
            phase=state.steps, scratch=scratch)

    def stuck_fn(state: EnvState) -> torch.Tensor:
        """Either arm stalled past its window (timeout, or timeout_spent
        once its phase budget is spent), or the global 120-tick backstop
        (an arm hovering just outside hold_tol is invisible to its own)."""
        sc = state.scratch
        window = mv.spent_timeout(sc["cfg"], sc["man_count"], state.phase)
        return ((sc["noprog"] >= window).any(dim=1)
                | (state.no_progress >= 120))

    def reset(batch: int, seed: int = 0) -> EnvState:
        """Robot jitter first, then obstacles clear of the posed links
        (the box overlaps the start pose), padded, then goals; all from one
        generator on the env's device seeded by `seed`, which goes on as
        EnvState.rng."""
        gen = torch.Generator(device=device).manual_seed(seed)
        q, qd = rnd.randomize_robot_config(gen, batch, space)
        p0, p1, r, _ = link_world_capsules_all(model, K.fk_all(model, q))
        obstacles = rnd.randomize_obstacles_box(
            gen, batch, n_obstacles, *OBS_BOX, avoid=(p0, p1, r),
            avoid_clearance=0.05)
        if obstacle_capacity is not None:
            obstacles = pad_obstacles(obstacles, obstacle_capacity)
        sim = SimState(q=q, qd=qd, t=torch.zeros(batch, device=device),
                       obstacles=obstacles, goal=sample_goals(gen, obstacles))
        return env_state(sim, scratch=dual_scratch(batch, device), rng=gen)

    env = Env(name="dual_panda/randomized_clutter", model=model,
              policies=policies, reset=reset, ee_frame=ees[0], device=device,
              solved_tol=0.03, bind_params=bind_params,
              is_solved_fn=is_solved_fn, goal_distance_fn=goal_distance_fn,
              context_fn=context_fn, on_solved=on_solved, stuck_fn=stuck_fn,
              pre_tick=pre_tick, enforce_velocity_limits=True, max_qdd=100.0,
              # the JAX package sets 8 warm GJK iterations, which a scene
              # with a context_fn never reads (every pair cold, 10)
              hull_warm_iters=8, resolve_method="solve")
    return env
