"""The N-link planar arm's env: the generality path, built from the public
pieces both packages share (the JAX package has no scene on this arm, so
it is in no registry; tests/test_torch_generality.py builds the same env
from the JAX package's pieces).

    env = planar.planar_arm_env(5)        # the card unless device= says

- model: build_model(make_planar_arm_spec(n_links));
- a v2 target attractor on the 'ee_joint' frame's position, with the
  cluttered scene's gains (p 0.3, d 0.6; envs/franka.py's v2 stack), the
  joint velocity cap and joint damping (no c-space bias: its goal is the
  Panda's), and the grouped obstacle policy over every collision frame;
- one vertical cylinder beside the goal (OBSTACLE), which the arms pass
  within the obstacle policy's 0.5 m modulation radius;
- reset: q = 0.3 on every joint at rest, goal (1.2, 1.2, 0.05), as the
  JAX package's generality test; resolve 'solve' (K1 on the batched step).
"""
from __future__ import annotations

from rmp_tpu_torch import default_device
from rmp_tpu_torch import taskmaps as tm
from rmp_tpu_torch.envs.base import Env, bind_goal, env_state
from rmp_tpu_torch.envs.franka import _obstacle_policies
from rmp_tpu_torch.models.specs import build_model, make_planar_arm_spec
from rmp_tpu_torch.policies import v2
from rmp_tpu_torch.sim.collision import cylinder_obstacle
from rmp_tpu_torch.sim.world import init_state

EE = "ee_joint"
GOAL = (1.2, 1.2, 0.05)
Q_START = 0.3
# (base position, rpy, radius, height) of the cylinder: upright, beside the
# goal, where the five- and twelve-link arms pass it 0.15 and 0.08 m clear
# on their way (CPU rollouts of 150 ticks)
OBSTACLE = ((1.6, 1.0, 0.05), (0.0, 0.0, 0.0), 0.05, 0.4)


def planar_policies(model, device) -> tuple:
    """The env's policy stack on `model`: attractor, velocity cap, damping
    and the grouped obstacle policy."""
    return (
        v2.target_attractor(
            goal=GOAL, taskmap=tm.chain(tm.fk_frame(model, EE),
                                        tm.to_position()),
            accel_p_gain=0.3, accel_d_gain=0.6, accel_norm_eps=0.075,
            metric_alpha_length_scale=0.05, min_metric_alpha=0.03,
            max_metric_scalar=1, min_metric_scalar=0.5,
            proximity_metric_boost_scalar=1.0,
            proximity_metric_boost_length_scale=0.02, name="attractor",
            device=device),
        v2.joint_velocity_cap(max_velocity=0.5, velocity_damping_region=0.15,
                              damping_gain=5.0, metric_weight=0.05),
        v2.joint_damping(accel_d_gain=1, metric_scalar=0.005, inertia=0.3),
        *_obstacle_policies(model))


def planar_arm_env(n_links: int, device=None) -> Env:
    """The N-link planar arm's env on `device` (default: the GPU)."""
    return planar_env(build_model(make_planar_arm_spec(n_links)), device,
                      name=f"planar_{n_links}link")


def planar_env(model, device=None, name: str | None = None) -> Env:
    """The planar arm's env on `model`, any model that keeps the arm's
    'ee_joint' frame (the arm with links added, a branch, a fixed tail):
    its goal, cylinder and policy stack, q = Q_START on every motor."""
    device = default_device(device)
    obstacle = cylinder_obstacle(*OBSTACLE, device=device)
    q0 = [Q_START] * model.n_q

    def reset(batch: int, seed: int = 0):
        return env_state(init_state(model, batch, device, q=q0,
                                    obstacles=obstacle, goal=GOAL), seed)

    return Env(name=name or model.name, model=model,
               policies=planar_policies(model, device), reset=reset,
               ee_frame=model.frame_index(EE), device=device,
               bind_params=bind_goal(("target", "attractor")),
               resolve_method="solve")
