"""Scene registry: the 23 scenes of the JAX package's registry, under the
same names."""
from rmp_tpu_torch import default_device
from rmp_tpu_torch.envs import (base, cameras, dual, franka,  # noqa: F401
                                maneuver, neural_clutter, neural_reach,
                                two_joint, ur5)
from rmp_tpu_torch.envs.base import (Env, EnvState, env_state,  # noqa: F401
                                     make_batched_control_step,
                                     make_batched_reset, make_batched_rollout,
                                     make_control_step, make_rollout)

REGISTRY = {
    "two_joint/01_target_rmp_only": two_joint.env_01_target_rmp_only,
    "two_joint/02_jointspace_biasing": two_joint.env_02_jointspace_biasing,
    "two_joint/03_jointlimit_avoiding": two_joint.env_03_jointlimit_avoiding,
    "two_joint/04_driving_into_jointlimits":
        two_joint.env_04_driving_into_jointlimits,
    "two_joint/05_obstacle_avoidance": two_joint.env_05_obstacle_avoidance,
    "two_joint/05_obstacle_avoidance_variant":
        two_joint.env_05_obstacle_avoidance_variant,
    "two_joint/neural_reach": neural_reach.env_neural_reach,
    "franka/neural_reach": neural_reach.env_neural_reach_franka,
    "franka/neural_clutter": neural_clutter.env_neural_clutter,
    "franka/01_target_rmp_only": franka.env_01_target_rmp_only,
    "franka/02_provoke_collision": franka.env_02_provoke_collision,
    "franka/03_self_avoidance": franka.env_03_self_avoidance,
    "franka/04_nullspace_control": franka.env_04_nullspace_control,
    "franka/05_obstacle_avoidance": franka.env_05_obstacle_avoidance,
    "franka/06_cluttered_environment": franka.env_06_cluttered_environment,
    "franka/pose_target": franka.env_pose_target,
    "franka/moving_obstacles": franka.env_moving_obstacles,
    "franka/moving_goal": franka.env_moving_goal,
    "franka/randomized_cluttered": franka.env_randomized_cluttered,
    "ur5/01_target_reaching": ur5.env_01_target_reaching,
    "ur5/02_obstacle_avoidance": ur5.env_02_obstacle_avoidance,
    "dual_panda/handover": dual.env_handover,
    "dual_panda/randomized_clutter": dual.env_randomized_clutter,
}


def make(name: str, device=None) -> Env:
    """The scene `name` on `device` (default: the GPU; raises without one)."""
    return REGISTRY[name](default_device(device))
