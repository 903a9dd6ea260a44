from rmp_tpu_torch.policies.base import Policy  # noqa: F401
from rmp_tpu_torch.policies.v2 import (cspace_biasing, joint_damping,  # noqa: F401
                                       joint_velocity_cap, obstacle_avoidance,
                                       target_attractor)
