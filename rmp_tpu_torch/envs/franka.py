"""Franka Panda scenes: the flagship 06_cluttered_environment and its
sister 05_obstacle_avoidance.

The port's part of `rmp_tpu/envs/franka.py`: the v2 policy stack, the
grouped obstacle policy (one policy over all 10 collision frames x the
scene's obstacles), the seven cylinders and six sequential goals of scene
06, the one tilted cylinder of scene 05.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rmp_tpu_torch import taskmaps as tm
from rmp_tpu_torch.envs.base import (Env, EnvState, bind_goal, env_state,
                                     take_row)
from rmp_tpu_torch.models import robots
from rmp_tpu_torch.policies import v2
from rmp_tpu_torch.sim.collision import ObstacleSet, cylinder_obstacle
from rmp_tpu_torch.sim.data import PAIRS_KEY
from rmp_tpu_torch.sim.world import init_state

EE = robots.PANDA_EE_FRAME
Q_READY = robots.PANDA_Q_READY


def _ee_pos_taskmap(model):
    return tm.chain(tm.fk_frame(model, EE), tm.to_position())


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


def _obstacle_policies(model):
    """One grouped ObstacleAvoidance policy over every collision frame x
    obstacle pair, on an FK∘distance chain (the JAX package's grouped=True
    form; the per-frame policy list is not ported)."""
    taskmap = tm.chain(tm.multi_fk_frames(model, model.collision_frames),
                       tm.frames_to_point_distance())
    pol = v2.obstacle_avoidance(
        taskmap=taskmap, name="collision_avoidance", margin=0.0,
        damping_gain=50, damping_std_dev=0.04, damping_robustness_eps=0.01,
        damping_velocity_gate_length_scale=0.01, repulsion_gain=800,
        repulsion_std_dev=0.01, metric_modulation_radius=0.5,
        metric_scalar=1, metric_exploder_std_dev=0.02,
        metric_exploder_eps=0.001)
    pol.ctx_key = PAIRS_KEY
    return [pol]


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

    def reset(batch: int) -> EnvState:
        return env_state(init_state(model, batch, device, q=Q_READY,
                                    obstacles=obstacle, goal=goal))

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

    def reset(batch: int) -> EnvState:
        return env_state(init_state(model, batch, device, q=Q_READY,
                                    obstacles=obstacles,
                                    goal=CLUTTERED_GOALS[0]))

    # max_qdd: pure divergence guard, identity on nominal trajectories
    return Env(name="franka/06_cluttered_environment", model=model,
               policies=policies, reset=reset, ee_frame=model.frame_index(EE),
               device=device, bind_params=bind_goal(("target", "attractor")),
               on_solved=on_solved, max_qdd=1000.0)
