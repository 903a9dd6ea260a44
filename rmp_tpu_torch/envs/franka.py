"""Franka Panda scenes: 01_target_rmp_only, 02_provoke_collision,
03_self_avoidance, 04_nullspace_control, 05_obstacle_avoidance, the
flagship 06_cluttered_environment, pose_target, moving_goal,
moving_obstacles and randomized_cluttered.

The port's `rmp_tpu/envs/franka.py`: scene 01's lone v1 target with
uniform goal resampling; scene 02's target through a cylinder with no
obstacle policy, blocked by contact forces; scene 03's per-frame
self-avoidance fed by a batched context_fn; scene 04's c-space bias from an
IK start; the v2 policy stack, the obstacle policies (one grouped policy
over all 10 collision frames x the scene's obstacles, or one per frame),
the seven cylinders and six sequential goals of scene 06, the one tilted
cylinder of scene 05; the orientation hold of pose_target; the two scenes
moved by update_scene, a goal on a circle and the cluttered scene's
cylinders swaying; and the domain-randomized scene with its escape
maneuvers, final push and stall timeout (pre_tick, a state-aware bind,
stuck_fn).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rmp_tpu_torch import taskmaps as tm
from rmp_tpu_torch.envs import maneuver as mv
from rmp_tpu_torch.envs.base import (Env, EnvState, bind_goal, env_state,
                                     resample_goal, take_row)
from rmp_tpu_torch.models import kinematics as K
from rmp_tpu_torch.models import robots
from rmp_tpu_torch.models.ik import inverse_kinematics
from rmp_tpu_torch.ops import geom
from rmp_tpu_torch.ops.cuda_fk import fk_derivatives_batched
from rmp_tpu_torch.policies import v1, v2
from rmp_tpu_torch.sim import randomizer as rnd
from rmp_tpu_torch.sim.collision import (ObstacleSet, cylinder_obstacle,
                                         pad_obstacles, robot_self_distances,
                                         robot_self_distances_hull,
                                         self_collision_pairs)
from rmp_tpu_torch.sim.data import PAIRS_KEY
from rmp_tpu_torch.sim.world import SimState, init_state

EE = robots.PANDA_EE_FRAME
Q_READY = robots.PANDA_Q_READY


def _ee_pos_taskmap(model):
    return tm.chain(tm.fk_frame(model, EE), tm.to_position())


def env_01_target_rmp_only(device) -> Env:
    """experiments/franka_panda/01_target_rmp_only.py: a v1 target on the
    EE, and a new uniform goal each time one is reached."""
    device = torch.device(device)
    model = robots.franka_panda()
    goal = [0.6, 0.0, 0.4]
    policies = (v1.target_policy(goal=goal, taskmap=_ee_pos_taskmap(model),
                                 alpha=0.1, beta=0.5, c=0.1, name="target",
                                 device=device),)

    def reset(batch: int, seed: int = 0) -> EnvState:
        return env_state(init_state(model, batch, device, q=Q_READY,
                                    goal=goal), seed)

    return Env(name="franka/01_target_rmp_only", model=model,
               policies=policies, reset=reset, ee_frame=model.frame_index(EE),
               device=device, bind_params=bind_goal(("target", "attractor")),
               on_solved=resample_goal([0.3, -0.7, 0.3], [0.7, 0.7, 0.7],
                                       device))


def env_02_provoke_collision(device, contact: bool = True) -> Env:
    """Failure probe: a v1 target straight through a cylinder of radius
    0.05, with no obstacle policy. With contact (the default) the penalty
    contact forces of every physics substep block the arm (sim/contact.py)
    instead of letting it pass through. Resolved by 'pinv', so K1 is not
    on its path; K3 runs once for the policies and once per substep."""
    device = torch.device(device)
    model = robots.franka_panda()
    goal = [0.0, -0.5, 0.5]
    policies = (v1.target_policy(goal=goal, taskmap=_ee_pos_taskmap(model),
                                 alpha=0.1, beta=0.5, c=0.1, name="target",
                                 device=device),)
    obstacle = cylinder_obstacle([0.3, -0.3, 0.5], [0.2, 0.0, 0.0],
                                 radius=0.05, height=0.3, device=device)

    def reset(batch: int, seed: int = 0) -> EnvState:
        return env_state(init_state(model, batch, device, q=Q_READY,
                                    obstacles=obstacle, goal=goal), seed)

    return Env(name="franka/02_provoke_collision", model=model,
               policies=policies, reset=reset, ee_frame=model.frame_index(EE),
               device=device, bind_params=bind_goal(("target", "attractor")),
               contact=contact, max_qdd=200.0)


def self_pair_context(model, T_all: torch.Tensor, pairs, rows: dict,
                      keys: dict, hull: bool = False) -> dict:
    """Context of self-collision policies: the closest points of the frame
    pairs `pairs` for T_all (B, F, 4, 4), capsule against capsule or (hull)
    hull against hull, and for each frame f of `rows` (f -> a device long
    tensor of its pairs' rows) the entry keys[f] of its rows, (B, P_f, ...),
    with each pair's nearest point on f in f's frame."""
    query = robot_self_distances_hull if hull else robot_self_distances
    pos_a, pos_b, normal, dist = query(model, T_all, pairs)
    ctx = {}
    for f, idx in rows.items():
        T = T_all[:, f, None]                           # (B, 1, 4, 4)
        pa = pos_a.index_select(1, idx)                 # (B, P_f, 3)
        d = dist.index_select(1, idx)
        rel = geom.mv(T[..., :3, :3].transpose(-1, -2), pa - T[..., :3, 3])
        ctx[keys[f]] = dict(
            pos_on_link=pa, pos_on_obstacle=pos_b.index_select(1, idx),
            normal=normal.index_select(1, idx), distance=d,
            relative_position=rel, mask=torch.ones_like(d))
    return ctx


def env_03_self_avoidance(device) -> Env:
    """Self-collision avoidance from the self-distances (capsule or, in the
    hull tier, hull against hull): the reference's 03_self_avoidance.py in
    working form. A v1 target on the EE, joint damping, and one v1
    CollisionAvoidance per collision frame that heads a self-collision pair
    (pairs 3 apart in the tree, less those closer than 12 cm at the ready
    pose), fed by a context_fn."""
    device = torch.device(device)
    model = robots.franka_panda()
    pairs = self_collision_pairs(model, n_neighbors=3, exclude_below=0.12,
                                 q_ref=Q_READY)
    frames = sorted({a for a, _ in pairs})
    policies = [
        v1.target_policy(goal=[0.6, 0.0, 0.4], taskmap=_ee_pos_taskmap(model),
                         alpha=0.1, beta=0.5, c=0.1, name="target",
                         device=device),
        v2.joint_damping(accel_d_gain=1, metric_scalar=0.005, inertia=0.3),
    ]
    for f in frames:
        frame = model.frame_names[f]
        taskmap = tm.chain(tm.fk_frame(model, frame), tm.relative_points())
        # r = 0.15: most link pairs of the arm sit within 0.4 m of each
        # other, where a wide radius turns avoidance into a standing bias
        pol = v1.collision_avoidance(
            taskmap=taskmap, eta_rep=0.1 * np.e, nu_rep=0.3, eta_damp=0.5,
            nu_damp=0.3, r=0.15, c=1e5, name=f"self_avoidance_for_{frame}")
        pol.ctx_key = frame
        policies.append(pol)
    # each frame's rows of the pair list, as device index tensors, so a
    # tick sends nothing from the host
    rows = {f: torch.as_tensor([i for i, (a, _) in enumerate(pairs)
                                if a == f], dtype=torch.long, device=device)
            for f in frames}

    def context_fn(model_, sim, T_all=None):
        if T_all is None:
            T_all = K.fk_all(model_, sim.q)
        return self_pair_context(
            model_, T_all, pairs, rows,
            {f: model_.frame_names[f] for f in frames},
            hull=env.collision_geometry == "hull")

    def reset(batch: int, seed: int = 0) -> EnvState:
        return env_state(init_state(model, batch, device, q=Q_READY,
                                    goal=[0.6, 0.0, 0.4]), seed)

    # context_fn reads the env, so setting env.collision_geometry after
    # construction reaches it
    env = Env(name="franka/03_self_avoidance", model=model,
              policies=tuple(policies), reset=reset,
              ee_frame=model.frame_index(EE), device=device,
              bind_params=bind_goal(("target", "attractor")),
              context_fn=context_fn,
              on_solved=resample_goal([0.3, -0.7, 0.3], [0.7, 0.7, 0.7],
                                      device))
    return env


def env_04_nullspace_control(device) -> Env:
    """experiments/franka_panda/04_nullspace_control.py: a v1 target and
    c-space biasing resolve the redundancy, from a start pose the IK finds
    at the goal (run on `device` at construction)."""
    device = torch.device(device)
    model = robots.franka_panda()
    policies = (
        v1.target_policy(goal=[0.6, 0.0, 0.5], taskmap=_ee_pos_taskmap(model),
                         alpha=0.1, beta=1.0, c=0.1, name="target",
                         device=device),
        v1.configuration_space_biasing(
            q0=[np.pi / 2, -0.05, 0, -2.01, 0, 2.22, 0.79, 0.02, 0.02],
            gamma_p=0.01, gamma_d=0.1, name="jointspace_biasing", w=0.05,
            device=device),
    )
    from scipy.spatial.transform import Rotation
    quat = Rotation.from_euler(
        "xyz", [np.pi / 16, np.pi / 16, 0]).as_quat().astype(np.float32)
    f32 = dict(dtype=torch.float32, device=device)
    q_start = inverse_kinematics(
        model, EE, torch.tensor([0.6, 0.0, 0.5], **f32),
        target_orientation_quat=torch.as_tensor(quat, **f32),
        q_init=torch.as_tensor(Q_READY, **f32))

    def reset(batch: int, seed: int = 0) -> EnvState:
        return env_state(init_state(model, batch, device, q=q_start,
                                    goal=[0.6, 0.0, 0.5]), seed)

    return Env(name="franka/04_nullspace_control", model=model,
               policies=policies, reset=reset, ee_frame=model.frame_index(EE),
               device=device, bind_params=bind_goal(("target", "attractor")))


def _v2_policy_stack(model, goal, attractor_p_gain, attractor_d_gain,
                     with_cspace_bias: bool, device, max_velocity: float = 0.5):
    """The shared v2 stack: EE attractor, joint velocity cap, joint damping
    and (optionally) c-space biasing."""
    policies = [
        v2.target_attractor(
            goal=goal, taskmap=_ee_pos_taskmap(model),
            accel_p_gain=attractor_p_gain, accel_d_gain=attractor_d_gain,
            accel_norm_eps=0.075, metric_alpha_length_scale=0.05,
            min_metric_alpha=0.03, max_metric_scalar=1, min_metric_scalar=0.5,
            proximity_metric_boost_scalar=1.0,
            proximity_metric_boost_length_scale=0.02, name="attractor",
            device=device),
        v2.joint_velocity_cap(max_velocity=max_velocity,
                              velocity_damping_region=0.15,
                              damping_gain=5.0, metric_weight=0.05),
        v2.joint_damping(accel_d_gain=1, metric_scalar=0.005, inertia=0.3),
    ]
    if with_cspace_bias:
        policies.append(v2.cspace_biasing(
            goal=[0.0, -0.9, 0.0, -2.8, 0.0, 2.0, 0.7853981633974483, 0.02,
                  0.02],
            metric_scalar=0.005, position_gain=1, damping_gain=2,
            robust_position_term_thresh=0.5, inertia=0.0001, device=device))
    return policies


def _obstacle_policies(model, grouped: bool = True, frames=None,
                       name: str = "collision_avoidance",
                       ctx_key: str | None = None):
    """ObstacleAvoidance over every collision frame on FK∘distance chains.
    grouped=True: one policy over all collision frames x obstacle pairs,
    reading the context's PAIRS_KEY entry; grouped=False: the reference's
    structure, one policy per collision frame reading that frame's entry.
    The pullback sums over the pairs either way, so both give one q̈.

    frames / name / ctx_key: the grouped policy over a subset of the
    collision frames, named `name`, reading the context entry `ctx_key`,
    which must then hold that subset's (B, L', K, ...) rows (the dual arm
    splits obstacle avoidance per arm, envs/dual.py)."""
    kw = dict(margin=0.0, damping_gain=50, damping_std_dev=0.04,
              damping_robustness_eps=0.01,
              damping_velocity_gate_length_scale=0.01, repulsion_gain=800,
              repulsion_std_dev=0.01, metric_modulation_radius=0.5,
              metric_scalar=1, metric_exploder_std_dev=0.02,
              metric_exploder_eps=0.001)
    if grouped:
        taskmap = tm.chain(
            tm.multi_fk_frames(model, model.collision_frames
                               if frames is None else frames),
            tm.frames_to_point_distance())
        pol = v2.obstacle_avoidance(taskmap=taskmap, name=name, **kw)
        pol.ctx_key = PAIRS_KEY if ctx_key is None else ctx_key
        return [pol]
    out = []
    for i in model.collision_frames:
        frame = model.frame_names[i]
        taskmap = tm.chain(tm.fk_frame(model, frame),
                           tm.frame_to_point_distance())
        pol = v2.obstacle_avoidance(
            taskmap=taskmap, name=f"collision_avoidance_for_{frame}", **kw)
        pol.ctx_key = frame
        out.append(pol)
    return out


def env_05_obstacle_avoidance(device) -> Env:
    """experiments/franka_panda/05_obstacle_avoidance.py: the v2 stack
    without c-space bias and one tilted cylinder; one goal, no resampling."""
    device = torch.device(device)
    model = robots.franka_panda()
    goal = [0.0, -0.5, 0.5]
    policies = tuple(
        _v2_policy_stack(model, goal=goal, attractor_p_gain=0.1,
                         attractor_d_gain=1.0, with_cspace_bias=False,
                         device=device)
        + _obstacle_policies(model))
    obstacle = cylinder_obstacle([0.3, -0.3, 0.5], [0.2, 0.0, 0.0], 0.025,
                                 0.3, device=device)

    def reset(batch: int, seed: int = 0) -> EnvState:
        return env_state(init_state(model, batch, device, q=Q_READY,
                                    obstacles=obstacle, goal=goal), seed)

    return Env(name="franka/05_obstacle_avoidance", model=model,
               policies=policies, reset=reset, ee_frame=model.frame_index(EE),
               device=device, bind_params=bind_goal(("target", "attractor")))


CLUTTERED_GOALS = np.array(
    [[0.2, -0.2, 0.5],
     [0.5, -0.4, 0.5],
     [0.6, -0.2, 0.7],
     [0.6, 0.0, 0.3],
     [0.4, 0.55, 0.65],
     [0.65, 0.35, 0.65]], dtype=np.float32)   # 06_cluttered_environment.py


def cluttered_obstacles(device=None) -> ObstacleSet:
    """The 7 cylinders of 06_cluttered_environment.py."""
    cyl = [
        ([0.35, -0.2, 0.55], [0.1, 0, 0], 0.025, 0.2),
        ([0.1, -0.4, 0.125], [0.1, 0, 0], 0.025, 0.3),
        ([0.33, -0.3, 0.7], [-1.7, 0.7, 0], 0.025, 0.3),
        ([0.55, 0.25, 0.5], [0.1, 0, 0], 0.025, 0.3),
        ([0.8, 0.25, 0.3], [0.1, 0, 0], 0.025, 0.3),
        ([0.5, 0.4, 0.31], [3.14 / 2, 0, 0], 0.025, 0.3),
        ([0.45, 0.1, 0.11], [3.14 / 2, 0, 0], 0.025, 0.3),
    ]
    return ObstacleSet.of(*[cylinder_obstacle(p, o, r, h, device=device)
                            for p, o, r, h in cyl])


def env_06_cluttered_environment(device) -> Env:
    """The flagship: full v2 stack + c-space bias + 10 collision frames x 7
    cylinders, six sequential goals advanced in-graph when reached."""
    device = torch.device(device)
    model = robots.franka_panda()
    policies = tuple(
        _v2_policy_stack(model, goal=CLUTTERED_GOALS[0], attractor_p_gain=0.3,
                         attractor_d_gain=0.6, with_cspace_bias=True,
                         device=device)
        + _obstacle_policies(model))
    obstacles = cluttered_obstacles(device)
    goals = torch.as_tensor(CLUTTERED_GOALS, device=device)

    def on_solved(state: EnvState) -> EnvState:
        nxt = torch.clamp(state.phase + 1, max=len(CLUTTERED_GOALS) - 1)
        sim = dataclasses.replace(state.sim, goal=take_row(goals, nxt))
        return dataclasses.replace(state, sim=sim, phase=nxt)

    def reset(batch: int, seed: int = 0) -> EnvState:
        return env_state(init_state(model, batch, device, q=Q_READY,
                                    obstacles=obstacles,
                                    goal=CLUTTERED_GOALS[0]), seed)

    # max_qdd: pure divergence guard, identity on nominal trajectories
    return Env(name="franka/06_cluttered_environment", model=model,
               policies=policies, reset=reset, ee_frame=model.frame_index(EE),
               device=device, bind_params=bind_goal(("target", "attractor")),
               on_solved=on_solved, max_qdd=1000.0)


def env_pose_target(device) -> Env:
    """Position and orientation: the EE moves to a new position while it
    holds its initial orientation, through a second v1 target on the 6-D
    rotation taskmap."""
    device = torch.device(device)
    model = robots.franka_panda()
    ee = model.frame_index(EE)
    T0 = K.fk_frame(model, torch.as_tensor(Q_READY), ee)
    r6_goal = torch.cat([T0[:3, 0], T0[:3, 1]]).numpy()
    policies = (
        v1.target_policy(goal=[0.45, 0.3, 0.5],
                         taskmap=_ee_pos_taskmap(model),
                         alpha=0.15, beta=0.6, c=0.1, name="target",
                         device=device),
        v1.target_policy(goal=r6_goal,
                         taskmap=tm.chain(tm.fk_frame(model, EE),
                                          tm.to_rotation6()),
                         alpha=0.4, beta=0.8, c=0.1, name="orientation_hold",
                         device=device),
        v2.joint_damping(accel_d_gain=1, metric_scalar=0.005, inertia=0.3),
    )

    def reset(batch: int, seed: int = 0) -> EnvState:
        return env_state(init_state(model, batch, device, q=Q_READY,
                                    goal=[0.45, 0.3, 0.5]), seed)

    return Env(name="franka/pose_target", model=model, policies=policies,
               reset=reset, ee_frame=ee, device=device,
               bind_params=bind_goal(("target", "attractor")),
               solved_tol=0.03)


def env_moving_goal(device, radius: float = 0.15, omega: float = 0.4,
                    center=(0.5, 0.0, 0.45)) -> Env:
    """Moving-target tracking: the goal orbits a circle in the y-z plane,
    a function of sim time set by update_scene, and a stiffer v2 attractor
    with a higher velocity cap tracks it. solved_count saturates at 1
    ('has locked on')."""
    device = torch.device(device)
    model = robots.franka_panda()
    policies = (
        v2.target_attractor(
            goal=list(center), taskmap=_ee_pos_taskmap(model),
            accel_p_gain=1.0, accel_d_gain=1.0, accel_norm_eps=0.075,
            metric_alpha_length_scale=0.05, min_metric_alpha=0.03,
            max_metric_scalar=1, min_metric_scalar=0.5,
            proximity_metric_boost_scalar=1.0,
            proximity_metric_boost_length_scale=0.02, name="attractor",
            device=device),
        v2.joint_velocity_cap(max_velocity=1.5, velocity_damping_region=0.3,
                              damping_gain=5.0, metric_weight=0.05),
        v2.joint_damping(accel_d_gain=1, metric_scalar=0.005, inertia=0.3),
        v2.cspace_biasing(
            goal=[0.0, -0.9, 0.0, -2.8, 0.0, 2.0, 0.7853981633974483, 0.02,
                  0.02],
            metric_scalar=0.005, position_gain=1, damping_gain=2,
            robust_position_term_thresh=0.5, inertia=0.0001, device=device),
    )
    c = np.asarray(center, np.float32)
    c_t = torch.as_tensor(c, device=device)

    def update_scene(sim):
        wt = omega * sim.t
        circle = torch.stack([torch.zeros_like(wt), torch.cos(wt),
                              torch.sin(wt)], dim=-1)        # (B, 3)
        return dataclasses.replace(sim, goal=c_t + radius * circle)

    def reset(batch: int, seed: int = 0) -> EnvState:
        return env_state(init_state(model, batch, device, q=Q_READY,
                                    goal=[c[0], c[1] + radius, c[2]]), seed)

    return Env(name="franka/moving_goal", model=model, policies=policies,
               reset=reset, ee_frame=model.frame_index(EE), device=device,
               bind_params=bind_goal(("target", "attractor")),
               update_scene=update_scene, solved_tol=0.04,
               resolve_method="solve", max_qdd=200.0)


def env_moving_obstacles(device, amplitude: float = 0.1,
                         omega: float = 1.0) -> Env:
    """Dynamic obstacle avoidance: the cluttered scene's seven cylinders
    sway sinusoidally (each along its own direction and phase, a function
    of sim time set by update_scene) while the flagship's stack pursues
    its six goals. update_scene leaves per-env (B, K, 3) obstacles."""
    device = torch.device(device)
    model = robots.franka_panda()
    policies = tuple(
        _v2_policy_stack(model, goal=CLUTTERED_GOALS[0], attractor_p_gain=0.3,
                         attractor_d_gain=0.6, with_cspace_bias=True,
                         device=device)
        + _obstacle_policies(model))
    base = cluttered_obstacles(device)
    K_obs = base.count
    angles = np.linspace(0, 2 * np.pi, K_obs, endpoint=False)
    dirs = torch.as_tensor(np.stack(
        [np.cos(angles), np.sin(angles), np.zeros(K_obs)],
        axis=-1).astype(np.float32), device=device)             # (K, 3)
    phases = torch.as_tensor(np.linspace(0, np.pi, K_obs).astype(np.float32),
                             device=device)
    goals = torch.as_tensor(CLUTTERED_GOALS, device=device)

    def update_scene(sim):
        shift = ((amplitude * torch.sin(omega * sim.t[:, None] + phases))
                 [..., None] * dirs)                            # (B, K, 3)
        obstacles = ObstacleSet(p0=base.p0 + shift, p1=base.p1 + shift,
                                radius=sim.obstacles.radius,
                                kinds=base.kinds)
        return dataclasses.replace(sim, obstacles=obstacles)

    def on_solved(state: EnvState) -> EnvState:
        nxt = torch.clamp(state.phase + 1, max=len(CLUTTERED_GOALS) - 1)
        sim = dataclasses.replace(state.sim, goal=take_row(goals, nxt))
        return dataclasses.replace(state, sim=sim, phase=nxt)

    def reset(batch: int, seed: int = 0) -> EnvState:
        return env_state(init_state(model, batch, device, q=Q_READY,
                                    obstacles=base,
                                    goal=CLUTTERED_GOALS[0]), seed)

    return Env(name="franka/moving_obstacles", model=model,
               policies=policies, reset=reset, ee_frame=model.frame_index(EE),
               device=device, bind_params=bind_goal(("target", "attractor")),
               on_solved=on_solved, update_scene=update_scene, max_qdd=100.0,
               resolve_method="solve")


def bucket_capacity(n: int, buckets=(8, 16)) -> int:
    """Smallest standard capacity bucket holding n obstacles: scenes with
    different obstacle counts within one bucket share one state shape."""
    for b in buckets:
        if n <= b:
            return b
    return n


# The randomized scene's escape and push knobs, per env in
# EnvState.scratch['cfg'] (maneuver.cfg_scratch): the JAX package's r5
# defaults, which its sweeps chose (rmp_tpu/envs/franka.py:388-518 gives
# the measurements behind each).
RANDOMIZED_CFG = dict(
    esc_trigger=40.0,      # no-progress ticks before a detour fires
    man_ticks=22.0,        # detour duration (the stall counter frozen)
    man_budget=2.0,        # detours per goal
    man_first_only=1.0,    # detours only before the first goal event ...
    man_budget_late=0.0,   # ... and this many per later goal
    esc_back=0.15,         # m, the detour's retreat from the goal
    esc_side=0.30,         # m, its sideways component
    esc_axis1=1.0,         # legacy waypoint: detour 1 slides along the
    #                        blocking cylinder's axis (0: random tangent)
    esc_cand=1.0,          # 1: the waypoint of four scored candidates
    #                        (± the axis, ± a random tangent); 0: legacy
    man_arrive=1.0,        # 1: a detour ends within 6 cm of its waypoint
    esc_cspace=1.0,        # c-space bias metric and gain scale in a detour
    esc_qspace=0.0,        # 1: bind the c-space goal to a DLS-IK pose at
    #                        the waypoint; 2: reverse out to the pose of
    #                        ~32 ticks ago (q_hist)
    esc_gate=999.0,        # m: detour only once this close (off)
    timeout=80.0,          # no-progress ticks before the goal resamples
    timeout_spent=50.0,    # ... once the detour budget is spent
    push_trigger=20.0,     # final push on a stall of this many ticks ...
    push_near=0.08,        # ... within this many m of the goal
    push_boost=3.0,        # attractor p-gain scale (d-gain by its sqrt)
    push_latch=0.0,        # 1: the push stays on until a detour or goal
    push_metric=1.0,       # attractor metric scale in the push
    push_relax=4.0,        # obstacle repulsion and metric / this in it
    push_relax_metric=0.0,  # 1: relax the obstacle metric only
    esc_relax=10.0,        # obstacle metric / this during a detour
    obs_margin=0.005,      # m added to the obstacle policy's margin
)
_WS_LO = np.asarray([-0.85, -0.85, 0.15], np.float32)
_WS_HI = np.asarray([0.85, 0.85, 0.95], np.float32)
HIST_EVERY = 8          # q_hist takes the pose every 8 ticks ...
HIST_SLOTS = 4          # ... in 4 slots: the last ~32 ticks old
IK_STEPS = 8            # DLS steps of the detour's configuration waypoint
ARRIVE_TOL = 0.06       # m: a detour within this of its waypoint ends


def randomized_scratch(q0: torch.Tensor) -> dict:
    """EnvState.scratch of the randomized scene for the start poses q0
    (B, n): no detour, no push, the q_hist ring filled with q0, and the
    knobs of RANDOMIZED_CFG."""
    B = q0.shape[0]
    zero = torch.zeros(B, dtype=torch.int32, device=q0.device)
    return dict(man_ticks=zero, man_count=zero.clone(),
                wp=torch.zeros(B, 3, dtype=q0.dtype, device=q0.device),
                q_wp=q0.clone(),
                q_hist=q0[:, None].repeat(1, HIST_SLOTS, 1),
                push_on=torch.zeros(B, dtype=torch.bool, device=q0.device),
                cfg=mv.cfg_scratch(RANDOMIZED_CFG, B, q0.device))


def ee_rows(model, q: torch.Tensor):
    """(EE position (B, 3), its Jacobian ∂p/∂q (B, 3, n)) at q (B, n), from
    one K3 launch (translation rows of the EE's flattened transform)."""
    ee = model.frame_index(EE)
    T16, _, J16, _ = fk_derivatives_batched(model, q, torch.zeros_like(q))
    return T16[:, ee, 3:12:4], J16[:, ee, 3:12:4]


def ik_toward(model, q: torch.Tensor, target: torch.Tensor, first=None):
    """The detour's configuration waypoint: IK_STEPS position-only DLS
    steps from q (B, n) toward the EE at target (B, 3),
    q - 0.5 Jeᵀ (Je Jeᵀ + 1e-4 I)⁻¹ e with e = target - p(q) and
    Je = -∂p/∂q, each clipped to the joint limits; one K3 launch per step
    (first: (p, ∂p/∂q) at q when the caller has them). From the wedged q
    the solution stays on the env's branch of the redundancy; it only
    steers a low-gain c-space bias."""
    c = K.model_constants(model, q.device, q.dtype)
    ridge = 1e-4 * torch.eye(3, dtype=q.dtype, device=q.device)
    for k in range(IK_STEPS):
        p, Jp = first if (k == 0 and first is not None) else ee_rows(model, q)
        e = target - p
        A = Jp @ Jp.transpose(-1, -2) + ridge
        # solve_ex: no error check, so no wait on the device
        x = torch.linalg.solve_ex(A, e[..., None])[0]
        q = torch.clamp(q + 0.5 * (Jp.transpose(-1, -2) @ x)[..., 0],
                        c["q_lower"], c["q_upper"])
    return q


def env_randomized_cluttered(device, n_obstacles: int = 7,
                             obstacle_capacity: int | None = "auto") -> Env:
    """Domain-randomized cluttered scenes (rmp_tpu/envs/franka.py:359-760):
    every env draws its own cylinders, robot jitter and goal from the
    reference's randomization spaces, and a new goal clear of its
    obstacles at each goal event (a goal reached, or stuck_fn's timeout).

    obstacle_capacity: the obstacle count every scene is padded to with
    inert far obstacles (pad_obstacles); "auto" takes the 8/16 bucket
    holding n_obstacles, None keeps n_obstacles.

    The escape maneuver (pre_tick): after esc_trigger ticks without
    progress the attractor is bound to a detour waypoint for man_ticks
    ticks (ended on arrival), chosen from four candidates scored on
    clearance and detour length; sim.goal is never touched, so the solved
    check and first-goal accounting stay exact. A near-goal stall first
    engages the final push (attractor gains up, obstacle policy relaxed).
    Per tick pre_tick launches K3 IK_STEPS times: once at [q, the pose of
    the q_hist ring] (the EE, the detour's reverse-out point and the first
    DLS Jacobian), then once per further DLS step."""
    device = torch.device(device)
    if obstacle_capacity == "auto":
        obstacle_capacity = bucket_capacity(n_obstacles)
    model = robots.franka_panda()
    ee_idx = model.frame_index(EE)
    ws_lo = torch.as_tensor(_WS_LO, device=device)
    ws_hi = torch.as_tensor(_WS_HI, device=device)

    def pre_tick(state: EnvState) -> EnvState:
        """The escape trigger and waypoint, the q_hist ring, the detour
        timers and the push latch, for every env (the JAX package's
        pre_tick under its vmap)."""
        sc = state.scratch
        cfg = sc["cfg"]
        sim = state.sim
        q = sim.q
        B = q.shape[0]
        trigger = ((state.no_progress >= cfg["esc_trigger"])
                   & (state.goal_best < cfg["esc_gate"])
                   & mv.budget_free(cfg, sc["man_ticks"], sc["man_count"],
                                    state.phase))
        q_past = sc["q_hist"][:, -1]
        p2, J2 = ee_rows(model, torch.cat([q, q_past]))
        ee, ee_past, J0 = p2[:B], p2[B:], J2[:B]
        to_goal = sim.goal - ee
        dist = torch.linalg.vector_norm(to_goal, dim=-1, keepdim=True)
        away = -to_goal / (dist + 1e-9)
        # a normal draw for every env each tick, kept where the trigger
        # fires (JAX splits each env's key and keeps the split there)
        v = rnd.normal(state.stream, B, 3, dtype=q.dtype)
        tang = v - torch.sum(v * away, dim=-1, keepdim=True) * away
        tang = tang / (torch.linalg.vector_norm(tang, dim=-1, keepdim=True)
                       + 1e-9)

        # candidate directions: ± the nearest cylinder's axis (the shortest
        # way around it) and ± the random tangent
        obs = sim.obstacles
        seg = obs.p1 - obs.p0                                  # (B, K, 3)
        seg_len2 = torch.sum(seg * seg, dim=-1)
        t_seg = torch.clamp(torch.sum((ee[:, None] - obs.p0) * seg, dim=-1)
                            / (seg_len2 + 1e-12), 0.0, 1.0)
        closest = obs.p0 + t_seg[..., None] * seg
        d_obs = (torch.linalg.vector_norm(ee[:, None] - closest, dim=-1)
                 - obs.radius)
        hot = d_obs <= d_obs.amin(dim=-1, keepdim=True)        # (B, K)
        axis = torch.sum(hot.to(q.dtype)[..., None] * seg, dim=1)
        axis = axis / (torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
                       + 1e-9)
        back = cfg["esc_back"][:, None] * away
        side_len = cfg["esc_side"][:, None]

        def waypoint(direction):
            return torch.clamp(ee + back + side_len * direction, ws_lo, ws_hi)
        best_wp, _ = mv.score_candidates(
            [waypoint(s) for s in (axis, -axis, tang, -tang)], sim.goal,
            lambda c: mv.point_clearance(obs, c))

        # the legacy guessed direction (esc_cand 0): the axis slide signed
        # toward the goal on detour 1, the random tangent on retries
        adot = torch.sum(axis * to_goal, dim=-1, keepdim=True)
        v0 = v[:, :1]
        sign = torch.where(torch.abs(adot) < 0.05,
                           torch.sign(v0) + (v0 == 0).to(q.dtype),
                           torch.sign(adot))
        side = torch.where(((sc["man_count"] == 0)
                            & (cfg["esc_axis1"] > 0.5))[:, None],
                           sign * axis, tang)
        wp = torch.where((cfg["esc_cand"] > 0.5)[:, None], best_wp,
                         waypoint(side))

        # the reverse-out ring: the pose every HIST_EVERY ticks
        shift = (state.steps % HIST_EVERY) == 0
        hist_next = torch.where(
            shift[:, None, None],
            torch.cat([q[:, None], sc["q_hist"][:, :-1]], dim=1),
            sc["q_hist"])
        mode2 = cfg["esc_qspace"] > 1.5
        wp = torch.where(mode2[:, None], ee_past, wp)

        ticks_next, count_next, wp_next = mv.maneuver_timers(
            cfg, sc["man_ticks"], sc["man_count"], trigger, ee, sc["wp"],
            wp, arrive_tol=ARRIVE_TOL)
        # the configuration waypoint, computed for every env each tick and
        # kept where the trigger fires: no wait on the device
        q_cand = torch.where(mode2[:, None], q_past,
                             ik_toward(model, q, wp, first=(ee, J0)))
        q_wp = torch.where(trigger[:, None], q_cand, sc["q_wp"])
        engage = mv.push_engaged(cfg, state.no_progress, state.goal_best)
        push_on = torch.where(
            cfg["push_latch"] > 0.5,
            (sc["push_on"] | engage) & ~trigger
            & (dist[:, 0] < 4.0 * cfg["push_near"]),
            engage)
        scratch = dict(sc, man_ticks=ticks_next, man_count=count_next,
                       wp=wp_next, q_wp=q_wp, q_hist=hist_next,
                       push_on=push_on)
        no_progress, goal_best = mv.freeze_progress(state, trigger,
                                                    ticks_next > 0)
        return dataclasses.replace(state, scratch=scratch,
                                   no_progress=no_progress,
                                   goal_best=goal_best)

    def bind(params, sim, pols, state):
        """During a detour the attractor chases the waypoint (the solved
        check keeps reading sim.goal); a near-miss stall engages the push
        gains. Every bound gain is a per-env (B,) tensor."""
        sc = state.scratch
        cfg = sc["cfg"]
        escaping = sc["man_ticks"] > 0
        goal = torch.where(escaping[:, None], sc["wp"], sim.goal)
        push = ~escaping & sc["push_on"]
        boost = torch.where(push, cfg["push_boost"], 1.0)
        mscale = torch.where(push, cfg["push_metric"], 1.0)
        relax = torch.where(push, cfg["push_relax"], 1.0)
        relax_rep = torch.where(cfg["push_relax_metric"] > 0.5, 1.0, relax)
        out = []
        for p, prm in zip(pols, params):
            if p.name == "attractor":
                prm = mv.scaled_attractor(prm, goal=goal, gain_boost=boost,
                                          metric_scale=mscale)
            elif p.name == "collision_avoidance":
                # the push's relax and the detour's metric relax exclude
                # each other (push = ~escaping & push_on)
                mrelax = relax * torch.where(escaping, cfg["esc_relax"], 1.0)
                prm = mv.relaxed_obstacle(prm, relax_rep, mrelax)
                prm["margin"] = prm["margin"] + cfg["obs_margin"]
            elif p.name == "cspace_target":
                cspace = torch.where(escaping, cfg["esc_cspace"], 1.0)
                qgoal = torch.where(
                    (escaping & (cfg["esc_qspace"] > 0.5))[:, None],
                    sc["q_wp"], prm["goal"])
                prm = dict(prm, goal=qgoal,
                           metric_scalar=prm["metric_scalar"] * cspace,
                           position_gain=prm["position_gain"] * cspace)
            out.append(prm)
        return tuple(out)

    # gains of the JAX package's sweep for this workload (p 2.5 / d 1.5 /
    # cap 0.8; the flagship keeps the reference's 0.3 / 0.6 / 0.5)
    policies = tuple(
        _v2_policy_stack(model, goal=[0.5, 0.0, 0.5], attractor_p_gain=2.5,
                         attractor_d_gain=1.5, with_cspace_bias=True,
                         device=device, max_velocity=0.8)
        + _obstacle_policies(model))

    def on_solved(state: EnvState) -> EnvState:
        """A goal event (reached or stuck): a new goal clear of the env's
        obstacles, a fresh detour budget, the push released; phase records
        the tick of the event."""
        B = state.sim.q.shape[0]
        goal = rnd.randomize_goal(state.stream, B,
                                  obstacles=state.sim.obstacles)
        zero = torch.zeros(B, dtype=torch.int32, device=goal.device)
        scratch = dict(state.scratch, man_ticks=zero, man_count=zero,
                       push_on=torch.zeros(B, dtype=torch.bool,
                                           device=goal.device))
        return dataclasses.replace(
            state, sim=dataclasses.replace(state.sim, goal=goal),
            phase=state.steps, scratch=scratch)

    def stuck_fn(state: EnvState) -> torch.Tensor:
        """No progress for the goal's stall window (spent_timeout)."""
        sc = state.scratch
        return state.no_progress >= mv.spent_timeout(
            sc["cfg"], sc["man_count"], state.phase)

    def reset(batch: int, seed: int = 0) -> EnvState:
        """Obstacles (padded to obstacle_capacity), robot jitter, then a
        goal clear of the obstacles, all from one generator on the env's
        device seeded by `seed`, which goes on as EnvState.rng."""
        gen = torch.Generator(device=device).manual_seed(seed)
        obstacles = rnd.randomize_obstacles(gen, batch, n_obstacles)
        if obstacle_capacity is not None:
            obstacles = pad_obstacles(obstacles, obstacle_capacity)
        q, qd = rnd.randomize_robot_config(gen, batch)
        goal = rnd.randomize_goal(gen, batch, obstacles=obstacles)
        sim = SimState(q=q, qd=qd, t=torch.zeros(batch, device=device),
                       obstacles=obstacles, goal=goal)
        return env_state(sim, scratch=randomized_scratch(q), rng=gen)

    return Env(name="franka/randomized_cluttered", model=model,
               policies=policies, reset=reset, ee_frame=ee_idx,
               device=device, bind_params=bind, on_solved=on_solved,
               stuck_fn=stuck_fn, pre_tick=pre_tick, max_qdd=100.0,
               enforce_velocity_limits=True,
               # fast randomized motion needs 8 warm GJK iterations in the
               # hull tier (reports/gjk_warm_accuracy.json)
               hull_warm_iters=8, resolve_method="solve")
