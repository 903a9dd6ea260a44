"""Robot model constructors and per-robot constants (the Panda only, so far).

Ready pose and limits are motor-ordered 9-vectors, the same values as
`rmp_tpu/models/robots.py`."""
from __future__ import annotations

import functools

import numpy as np

from rmp_tpu_torch.models.specs import PANDA_SPEC, build_model
from rmp_tpu_torch.models.urdf import KinematicModel

PANDA_Q_READY = np.array(
    [0.0, -0.3, 0.0, -2.2, 0.0, 2.0, np.pi / 4, 0.02, 0.02], dtype=np.float32)
PANDA_Q_LIM_LOW = np.array(
    [-2.9671, -1.8326, -2.9671, -3.1416, -2.9671, -0.0873, -2.9671, 0.0, 0.0],
    dtype=np.float32)
PANDA_Q_LIM_HIGH = np.array(
    [2.9671, 1.8326, 2.9671, 0.0, 2.9671, 3.8223, 2.9671, 0.04, 0.04],
    dtype=np.float32)

PANDA_EE_FRAME = "panda_grasptarget_hand"


@functools.lru_cache(maxsize=None)
def franka_panda() -> KinematicModel:
    """9-DOF Franka Panda (7 revolute + 2 prismatic fingers) with the
    25-capsule collision set; EE frame 'panda_grasptarget_hand'."""
    return build_model(PANDA_SPEC)
