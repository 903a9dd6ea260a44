from rmp_tpu_torch.sim import collision, data, dynamics, objects, world  # noqa: F401
from rmp_tpu_torch.sim.collision import ObstacleSet  # noqa: F401
from rmp_tpu_torch.sim.objects import (Cylinder, FrankaPanda, Goal, Sphere,  # noqa: F401
                                       TwoJointRobot)
from rmp_tpu_torch.sim.world import (SimState, Simulation, init_state,  # noqa: F401
                                     physics_step, scene_to_obstacles, sense)
