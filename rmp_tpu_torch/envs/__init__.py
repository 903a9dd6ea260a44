"""Scene registry: the flagship scene 06 and its sister scene 05."""
from rmp_tpu_torch import default_device
from rmp_tpu_torch.envs import base, franka  # noqa: F401
from rmp_tpu_torch.envs.base import (Env, EnvState, env_state,  # noqa: F401
                                     make_batched_control_step,
                                     make_batched_reset, make_batched_rollout)

REGISTRY = {
    "franka/05_obstacle_avoidance": franka.env_05_obstacle_avoidance,
    "franka/06_cluttered_environment": franka.env_06_cluttered_environment,
}


def make(name: str, device=None) -> Env:
    """The scene `name` on `device` (default: the GPU; raises without one)."""
    return REGISTRY[name](default_device(device))
