"""Franka Panda scenes: 01_target_rmp_only, 03_self_avoidance,
04_nullspace_control, 05_obstacle_avoidance, the flagship
06_cluttered_environment, pose_target, moving_goal and moving_obstacles.

The port's part of `rmp_tpu/envs/franka.py`: scene 01's lone v1 target with
uniform goal resampling; scene 03's per-frame self-avoidance fed by a
batched context_fn; scene 04's c-space bias from an IK start; the v2 policy
stack, the obstacle policies (one grouped policy over all 10 collision
frames x the scene's obstacles, or one per frame), the seven cylinders and
six sequential goals of scene 06, the one tilted cylinder of scene 05; the
orientation hold of pose_target; and the two scenes moved by update_scene,
a goal on a circle and the cluttered scene's cylinders swaying.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rmp_tpu_torch import taskmaps as tm
from rmp_tpu_torch.envs.base import (Env, EnvState, bind_goal, env_state,
                                     resample_goal, take_row)
from rmp_tpu_torch.models import kinematics as K
from rmp_tpu_torch.models import robots
from rmp_tpu_torch.models.ik import inverse_kinematics
from rmp_tpu_torch.ops import geom
from rmp_tpu_torch.policies import v1, v2
from rmp_tpu_torch.sim.collision import (ObstacleSet, cylinder_obstacle,
                                         robot_self_distances,
                                         self_collision_pairs)
from rmp_tpu_torch.sim.data import PAIRS_KEY
from rmp_tpu_torch.sim.world import init_state

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


def env_03_self_avoidance(device) -> Env:
    """Self-collision avoidance from the capsule self-distances: the
    reference's 03_self_avoidance.py in working form. A v1 target on the EE,
    joint damping, and one v1 CollisionAvoidance per collision frame that
    heads a self-collision pair (pairs 3 apart in the tree, less those
    closer than 12 cm at the ready pose), fed by a context_fn."""
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
        if env.collision_geometry == "hull":
            raise NotImplementedError(
                "franka/03_self_avoidance in the hull tier needs "
                "robot_self_distances_hull, not ported yet (ROADMAP M12)")
        if T_all is None:
            T_all = K.fk_all(model_, sim.q)
        pos_a, pos_b, normal, dist = robot_self_distances(model_, T_all,
                                                          pairs)
        ctx = {}
        for f in frames:
            idx = rows[f]
            T = T_all[:, f, None]                       # (B, 1, 4, 4)
            pa = pos_a.index_select(1, idx)             # (B, P_f, 3)
            d = dist.index_select(1, idx)
            rel = geom.mv(T[..., :3, :3].transpose(-1, -2),
                          pa - T[..., :3, 3])
            ctx[model_.frame_names[f]] = dict(
                pos_on_link=pa, pos_on_obstacle=pos_b.index_select(1, idx),
                normal=normal.index_select(1, idx), distance=d,
                relative_position=rel, mask=torch.ones_like(d))
        return ctx

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


def _obstacle_policies(model, grouped: bool = True):
    """ObstacleAvoidance over every collision frame on FK∘distance chains.
    grouped=True: one policy over all collision frames x obstacle pairs,
    reading the context's PAIRS_KEY entry; grouped=False: the reference's
    structure, one policy per collision frame reading that frame's entry.
    The pullback sums over the pairs either way, so both give one q̈."""
    kw = dict(margin=0.0, damping_gain=50, damping_std_dev=0.04,
              damping_robustness_eps=0.01,
              damping_velocity_gate_length_scale=0.01, repulsion_gain=800,
              repulsion_std_dev=0.01, metric_modulation_radius=0.5,
              metric_scalar=1, metric_exploder_std_dev=0.02,
              metric_exploder_eps=0.001)
    if grouped:
        taskmap = tm.chain(tm.multi_fk_frames(model, model.collision_frames),
                           tm.frames_to_point_distance())
        pol = v2.obstacle_avoidance(taskmap=taskmap,
                                    name="collision_avoidance", **kw)
        pol.ctx_key = PAIRS_KEY
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
