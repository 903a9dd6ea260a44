"""Planar two-joint robot scenes (the reference's experiments/two_joint_robot/).

The port's `rmp_tpu/envs/two_joint.py`: each scene function reproduces one
reference script's v1 policy set, gains, scene and resampling, on B
environments at once.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rmp_tpu_torch import taskmaps as tm
from rmp_tpu_torch.envs.base import (Env, EnvState, bind_goal, env_state,
                                     resample_goal)
from rmp_tpu_torch.models import kinematics as K
from rmp_tpu_torch.models import robots
from rmp_tpu_torch.policies import v1
from rmp_tpu_torch.sim import randomizer as rnd
from rmp_tpu_torch.sim.collision import cylinder_obstacle
from rmp_tpu_torch.sim.data import PAIRS_KEY
from rmp_tpu_torch.sim.world import init_state

EE = robots.TWO_JOINT_EE_FRAME
Q_LOW = robots.TWO_JOINT_Q_LIM_LOW
Q_HIGH = robots.TWO_JOINT_Q_LIM_HIGH
GOAL = [1.4, -1.4, 0.1]


def _ee_pos_taskmap(model):
    return tm.chain(tm.fk_frame(model, EE), tm.to_position())


def _resample_q(model, device):
    """on_solved: a new uniform configuration within the joint limits and
    zero velocity, for every env (kept where a goal was reached)."""
    c = K.model_constants(model, device)
    low, span = c["q_lower"], c["q_upper"] - c["q_lower"]

    def on_solved(state: EnvState) -> EnvState:
        u = rnd.uniform(state.stream, state.sim.q.shape[0], model.n_q)
        q = low + span * u
        return dataclasses.replace(state, sim=dataclasses.replace(
            state.sim, q=q, qd=torch.zeros_like(q)))
    return on_solved


def _mid_limit_ee(model) -> np.ndarray:
    """The EE position at the middle of the joint limits: the goal of the
    solved check of scenes 03 and 04."""
    mid = torch.as_tensor(0.5 * (Q_LOW + Q_HIGH))
    return K.fk_frame(model, mid, model.frame_index(EE))[:3, 3].numpy()


def env_01_target_rmp_only(device) -> Env:
    """experiments/two_joint_robot/01_target_rmp_only.py: a v1 target, and
    a new uniform goal each time one is reached."""
    device = torch.device(device)
    model = robots.two_joint_robot()
    policies = (v1.target_policy(goal=GOAL, taskmap=_ee_pos_taskmap(model),
                                 alpha=0.1, beta=0.5, c=0.1, name="target",
                                 device=device),)

    def reset(batch: int, seed: int = 0) -> EnvState:
        return env_state(init_state(model, batch, device,
                                    q=robots.TWO_JOINT_Q_READY, goal=GOAL),
                         seed)

    return Env(name="two_joint/01_target_rmp_only", model=model,
               policies=policies, reset=reset, ee_frame=model.frame_index(EE),
               device=device, solved_xy_only=True,
               bind_params=bind_goal(("target",)),
               on_solved=resample_goal([0.1, 0.1, 0.1], GOAL, device))


def env_02_jointspace_biasing(device, bias_left: bool = True) -> Env:
    """experiments/two_joint_robot/02_jointspace_biasing.py: the target
    and a c-space bias toward elbow-left (q0 = [pi/2, 0]) or elbow-right
    ([-pi/2, 0])."""
    device = torch.device(device)
    model = robots.two_joint_robot()
    q0 = [np.pi / 2, 0.0] if bias_left else [-np.pi / 2, 0.0]
    goal = [1.5, 0.0, 0.1]
    policies = (
        v1.target_policy(goal=goal, taskmap=_ee_pos_taskmap(model),
                         alpha=0.1, beta=0.5, c=0.1, name="target",
                         device=device),
        v1.configuration_space_biasing(q0=q0, gamma_p=0.01, gamma_d=0.1,
                                       name="ConfigurationSpaceBias",
                                       device=device),
    )

    def reset(batch: int, seed: int = 0) -> EnvState:
        return env_state(init_state(model, batch, device,
                                    q=robots.TWO_JOINT_Q_READY, goal=goal),
                         seed)

    return Env(name="two_joint/02_jointspace_biasing", model=model,
               policies=policies, reset=reset, ee_frame=model.frame_index(EE),
               device=device, solved_xy_only=True,
               bind_params=bind_goal(("target",)))


def env_03_jointlimit_avoiding(device) -> Env:
    """experiments/two_joint_robot/03_jointlimit_avoiding.py: the
    limit-avoidance RMP alone drives the arm from q = [pi/4, pi/4] back
    toward mid-range; a new random configuration once it is there."""
    device = torch.device(device)
    model = robots.two_joint_robot()
    policies = (v1.joint_limit_avoidance(Q_LOW, Q_HIGH, gamma_p=0.3,
                                         gamma_d=1.0, device=device),)
    goal = _mid_limit_ee(model)

    def reset(batch: int, seed: int = 0) -> EnvState:
        return env_state(init_state(model, batch, device,
                                    q=[np.pi / 4, np.pi / 4], goal=goal),
                         seed)

    return Env(name="two_joint/03_jointlimit_avoiding", model=model,
               policies=policies, reset=reset, ee_frame=model.frame_index(EE),
               device=device, solved_xy_only=True, check_velocity=0.01,
               on_solved=_resample_q(model, device))


def env_04_driving_into_jointlimits(device) -> Env:
    """experiments/two_joint_robot/04_driving_into_jointlimits.py: a target
    in configuration space (identity taskmap, a 2-vector goal) pulls joint
    1 to its lower limit while the limit-avoidance RMP resists."""
    device = torch.device(device)
    model = robots.two_joint_robot()
    policies = (
        v1.target_policy(goal=[float(Q_LOW[0]), 0.0], taskmap=tm.identity(),
                         alpha=0.1, beta=1.0, c=0.1, name="Target_RMP",
                         device=device),
        v1.joint_limit_avoidance(Q_LOW, Q_HIGH, gamma_p=0.2, gamma_d=1.0,
                                 device=device),
    )
    goal = _mid_limit_ee(model)

    def reset(batch: int, seed: int = 0) -> EnvState:
        return env_state(init_state(model, batch, device,
                                    q=[-np.pi / 4, -np.pi / 4], goal=goal),
                         seed)

    return Env(name="two_joint/04_driving_into_jointlimits", model=model,
               policies=policies, reset=reset, ee_frame=model.frame_index(EE),
               device=device, solved_xy_only=True, check_velocity=0.001,
               on_solved=_resample_q(model, device))


def env_05_obstacle_avoidance(device) -> Env:
    """experiments/two_joint_robot/05_obstacle_avoidance.py: the target and
    one grouped v1 collision avoidance over every (collision frame x
    obstacle) pair, on an FK∘relative-point chain (the same math as the
    reference's per-frame list)."""
    device = torch.device(device)
    model = robots.two_joint_robot()
    grouped = v1.collision_avoidance(
        taskmap=tm.chain(tm.multi_fk_frames(model, model.collision_frames),
                         tm.frames_relative_points()),
        eta_rep=0.1 * np.e, nu_rep=0.3, eta_damp=1.0, nu_damp=0.3, r=1.1,
        c=1e5, name="collision_avoidance")
    grouped.ctx_key = PAIRS_KEY
    policies = (
        v1.target_policy(goal=GOAL, taskmap=_ee_pos_taskmap(model),
                         alpha=0.1, beta=0.1, c=0.1, name="target",
                         device=device),
        grouped,
    )
    obstacle = cylinder_obstacle([1.6, -0.8, 0.0], [0.0, 0.0, 0.0],
                                 radius=0.1, height=0.8, device=device)

    def reset(batch: int, seed: int = 0) -> EnvState:
        return env_state(init_state(model, batch, device,
                                    q=robots.TWO_JOINT_Q_READY,
                                    obstacles=obstacle, goal=GOAL), seed)

    return Env(name="two_joint/05_obstacle_avoidance", model=model,
               policies=policies, reset=reset, ee_frame=model.frame_index(EE),
               device=device, solved_xy_only=True,
               bind_params=bind_goal(("target",)))


def env_05_obstacle_avoidance_variant(device) -> Env:
    """The reference's '05_obstacle_avoidance copy.py' gains: stiffer target
    damping (beta 0.5), softer wide-radius collision damping (eta_damp 0.1,
    nu_damp 0.6, r 3)."""
    env = env_05_obstacle_avoidance(device)
    target, grouped = env.policies
    policies = (target.with_params(beta=0.5),
                grouped.with_params(eta_damp=0.1, nu_damp=0.6, r=3.0))
    return dataclasses.replace(
        env, policies=policies,
        name="two_joint/05_obstacle_avoidance_variant")
