"""Robot model constructors and per-robot constants: the planar two-joint
arm, the Franka Panda and the UR5.

Ready poses and limits are motor-ordered vectors, the same values as
`rmp_tpu/models/robots.py`."""
from __future__ import annotations

import functools

import numpy as np

from rmp_tpu_torch.models.specs import (PANDA_SPEC, TWO_JOINT_SPEC, UR5_SPEC,
                                        build_model)
from rmp_tpu_torch.models.urdf import KinematicModel

TWO_JOINT_Q_READY = np.array([0.0, 0.0], dtype=np.float32)
TWO_JOINT_Q_LIM_LOW = np.array([-np.pi, -np.pi], dtype=np.float32)
TWO_JOINT_Q_LIM_HIGH = np.array([np.pi, np.pi], dtype=np.float32)

PANDA_Q_READY = np.array(
    [0.0, -0.3, 0.0, -2.2, 0.0, 2.0, np.pi / 4, 0.02, 0.02], dtype=np.float32)
PANDA_Q_LIM_LOW = np.array(
    [-2.9671, -1.8326, -2.9671, -3.1416, -2.9671, -0.0873, -2.9671, 0.0, 0.0],
    dtype=np.float32)
PANDA_Q_LIM_HIGH = np.array(
    [2.9671, 1.8326, 2.9671, 0.0, 2.9671, 3.8223, 2.9671, 0.04, 0.04],
    dtype=np.float32)

TWO_JOINT_EE_FRAME = "link_23"
PANDA_EE_FRAME = "panda_grasptarget_hand"

UR5_Q_READY = np.array([0.0, -1.5708, 1.2, -1.2, -1.5708, 0.0],
                       dtype=np.float32)
UR5_EE_FRAME = "ee_fixed_joint"


@functools.lru_cache(maxsize=None)
def two_joint_robot() -> KinematicModel:
    """Planar 2-DOF arm (2 revolute + the fixed EE frame 'link_23')."""
    return build_model(TWO_JOINT_SPEC)


@functools.lru_cache(maxsize=None)
def franka_panda() -> KinematicModel:
    """9-DOF Franka Panda (7 revolute + 2 prismatic fingers) with the
    25-capsule collision set; EE frame 'panda_grasptarget_hand'."""
    return build_model(PANDA_SPEC)


@functools.lru_cache(maxsize=None)
def ur5() -> KinematicModel:
    """6-DOF UR5 (6 revolute + the fixed EE frame 'ee_fixed_joint')."""
    return build_model(UR5_SPEC)
