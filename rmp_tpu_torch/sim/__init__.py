from rmp_tpu_torch.sim import collision, data, dynamics, world  # noqa: F401
from rmp_tpu_torch.sim.collision import ObstacleSet  # noqa: F401
from rmp_tpu_torch.sim.world import SimState, init_state, physics_step, sense  # noqa: F401
