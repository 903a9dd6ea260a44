from rmp_tpu_torch.models import fk_derivatives, kinematics, robots, specs, urdf  # noqa: F401
from rmp_tpu_torch.models.urdf import CollisionPrimitive, KinematicModel  # noqa: F401
