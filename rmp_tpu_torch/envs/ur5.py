"""UR5 scenes: the third robot family, on the same layers as the Panda.

The port's `rmp_tpu/envs/ur5.py`. Both scenes resolve with 'solve', so on
the card they run K1 at n = 6.
"""
from __future__ import annotations

import torch

from rmp_tpu_torch import taskmaps as tm
from rmp_tpu_torch.envs.base import (Env, EnvState, bind_goal, env_state,
                                     resample_goal)
from rmp_tpu_torch.models import robots
from rmp_tpu_torch.policies import v1, v2
from rmp_tpu_torch.sim.collision import cylinder_obstacle
from rmp_tpu_torch.sim.data import PAIRS_KEY
from rmp_tpu_torch.sim.world import init_state

EE = robots.UR5_EE_FRAME


def _ee_pos_taskmap(model):
    return tm.chain(tm.fk_frame(model, EE), tm.to_position())


def env_01_target_reaching(device) -> Env:
    """Target reaching with the v2 stack (attractor, velocity cap,
    damping), a new uniform goal each time one is reached."""
    device = torch.device(device)
    model = robots.ur5()
    goal = [0.5, 0.3, 0.4]
    policies = (
        v2.target_attractor(
            goal=goal, taskmap=_ee_pos_taskmap(model),
            accel_p_gain=0.3, accel_d_gain=0.6, accel_norm_eps=0.075,
            metric_alpha_length_scale=0.05, min_metric_alpha=0.03,
            max_metric_scalar=1, min_metric_scalar=0.5,
            proximity_metric_boost_scalar=1.0,
            proximity_metric_boost_length_scale=0.02, name="attractor",
            device=device),
        v2.joint_velocity_cap(max_velocity=1.0, velocity_damping_region=0.3,
                              damping_gain=5.0, metric_weight=0.05),
        v2.joint_damping(accel_d_gain=1, metric_scalar=0.005, inertia=0.3),
    )

    def reset(batch: int, seed: int = 0) -> EnvState:
        return env_state(init_state(model, batch, device,
                                    q=robots.UR5_Q_READY, goal=goal), seed)

    return Env(name="ur5/01_target_reaching", model=model, policies=policies,
               reset=reset, ee_frame=model.frame_index(EE), device=device,
               bind_params=bind_goal(("attractor",)),
               on_solved=resample_goal([0.3, -0.5, 0.2], [0.6, 0.5, 0.6],
                                       device),
               resolve_method="solve")


def env_02_obstacle_avoidance(device) -> Env:
    """Reach past a vertical cylinder: a v1 target, v2 joint damping and
    one grouped v1 collision avoidance on FK∘relative-point chains (the
    construction of two_joint/05, on the UR5)."""
    device = torch.device(device)
    model = robots.ur5()
    goal = [0.55, 0.35, 0.3]
    grouped = v1.collision_avoidance(
        taskmap=tm.chain(tm.multi_fk_frames(model, model.collision_frames),
                         tm.frames_relative_points()),
        eta_rep=0.1 * 2.718, nu_rep=0.3, eta_damp=0.5, nu_damp=0.3, r=0.3,
        c=1e5, name="collision_avoidance")
    grouped.ctx_key = PAIRS_KEY
    policies = (
        v1.target_policy(goal=goal, taskmap=_ee_pos_taskmap(model),
                         alpha=0.3, beta=0.5, c=0.1, name="target",
                         device=device),
        v2.joint_damping(accel_d_gain=1, metric_scalar=0.005, inertia=0.3),
        grouped,
    )
    obstacle = cylinder_obstacle([0.45, 0.0, 0.2], [0.0, 0.0, 0.0],
                                 radius=0.04, height=0.5, device=device)

    def reset(batch: int, seed: int = 0) -> EnvState:
        return env_state(init_state(model, batch, device,
                                    q=robots.UR5_Q_READY, obstacles=obstacle,
                                    goal=goal), seed)

    return Env(name="ur5/02_obstacle_avoidance", model=model,
               policies=policies, reset=reset, ee_frame=model.frame_index(EE),
               device=device, bind_params=bind_goal(("target",)),
               resolve_method="solve", solved_tol=0.03)
