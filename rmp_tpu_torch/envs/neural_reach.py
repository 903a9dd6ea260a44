"""Learned-policy reach scenes: an MLP attractor on the two-joint robot or
the Panda, batched.

The port's `rmp_tpu/envs/neural_reach.py`, serving only: the scenes run the
committed trained weights (assets/neural_reach_two_joint.npz,
assets/neural_reach_franka.npz; numpy arrays 'w0', 'b0', ...). Each env
draws its own goal at reset, from the two-joint robot's box or the
reference's cylindrical Panda goal space, from a generator on the env's
device seeded by the reset's seed. No goal is resampled: solved_count
saturates at 1.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from rmp_tpu_torch import taskmaps as tm
from rmp_tpu_torch.envs.base import Env, EnvState, bind_goal, env_state
from rmp_tpu_torch.models import robots
from rmp_tpu_torch.policies import neural, v2
from rmp_tpu_torch.sim import randomizer as rnd
from rmp_tpu_torch.sim.world import init_state

GOAL_LOW = (0.1, -1.4, 0.1)
GOAL_HIGH = (1.4, 0.1, 0.1)
_ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                       os.pardir, "assets")
ASSET = os.path.join(_ASSETS, "neural_reach_two_joint.npz")
ASSET_FRANKA = os.path.join(_ASSETS, "neural_reach_franka.npz")


def make_neural_env(device, net: dict | None = None,
                    gen: torch.Generator | None = None, hidden=(32, 32),
                    robot: str = "two_joint") -> Env:
    """Reaching scene with a neural attractor and joint damping, resolved
    by 'cholesky', and a random goal per env at reset.

    robot: 'two_joint' (goals uniform in the box GOAL_LOW..GOAL_HIGH, the
    solved check in x and y) or 'franka' (the reference's cylindrical goal
    space). net: trained MLP weights on `device`; None draws fresh ones
    from `gen` (default seeded 0)."""
    device = torch.device(device)
    if robot == "two_joint":
        model = robots.two_joint_robot()
        ee, q0 = robots.TWO_JOINT_EE_FRAME, robots.TWO_JOINT_Q_READY
        # workspace-scale feature normalisation (keeps the tanh layers in
        # their linear range)
        feat_scale = [2.0, 2.0, 2.0, 5.0, 5.0, 5.0]
        xy_only = True

        def sample_goal(g, batch):
            u = rnd.uniform(g, batch, 3)
            return rnd.scale_uniform(u, np.asarray(GOAL_LOW, np.float32),
                                     np.asarray(GOAL_HIGH, np.float32))
    elif robot == "franka":
        model = robots.franka_panda()
        ee, q0 = robots.PANDA_EE_FRAME, robots.PANDA_Q_READY
        feat_scale = [1.0, 1.0, 1.0, 2.0, 2.0, 2.0]
        xy_only = False

        def sample_goal(g, batch):
            return rnd.randomize_goal(g, batch)
    else:
        raise ValueError(f"unknown robot {robot!r}")

    taskmap = tm.chain(tm.fk_frame(model, ee), tm.to_position())
    if net is None:
        gen = gen if gen is not None else torch.Generator(
            device=device).manual_seed(0)
        net = neural.mlp_init(gen, (6, *hidden, neural.head_sizes(3)),
                              device=device)
    policies = (
        neural.neural_attractor(goal=[0.0, 0.0, 0.0], taskmap=taskmap,
                                net=net, name="neural_target",
                                feat_scale=feat_scale, device=device),
        v2.joint_damping(accel_d_gain=0.2, metric_scalar=0.2, inertia=0.1),
    )

    def reset(batch: int, seed: int = 0) -> EnvState:
        """`batch` envs at the ready pose, each with its own goal drawn
        from a generator seeded by `seed`, which goes on as EnvState.rng."""
        g = torch.Generator(device=device).manual_seed(seed)
        sim = init_state(model, batch, device, q=q0)
        sim.goal = sample_goal(g, batch)
        return env_state(sim, rng=g)

    return Env(name=f"{robot}/neural_reach", model=model, policies=policies,
               reset=reset, ee_frame=model.frame_index(ee), device=device,
               solved_xy_only=xy_only, resolve_method="cholesky",
               # backstop behind the tanh accel bound
               max_qdd=100.0, bind_params=bind_goal(("neural_target",)))


def load_trained_net(path: str, device) -> dict:
    """Committed trained weights as tensors on `device`."""
    from rmp_tpu_torch.convert import net_from_numpy
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path} missing: the trained weights are "
                                "committed with the repository")
    with np.load(path) as data:
        return net_from_numpy(data, device)


def env_neural_reach(device) -> Env:
    """Registered scene: the trained two-joint attractor on random goals."""
    return make_neural_env(device, net=load_trained_net(ASSET, device))


def env_neural_reach_franka(device) -> Env:
    """Registered scene: the trained Panda attractor on random goals."""
    return make_neural_env(device, net=load_trained_net(ASSET_FRANKA, device),
                           robot="franka")
