"""Robot model constructors and per-robot constants: the planar two-joint
arm, the Franka Panda, the UR5 and the dual-arm Panda.

Ready poses and limits are motor-ordered vectors, the same values as
`rmp_tpu/models/robots.py`."""
from __future__ import annotations

import functools
import os

import numpy as np

from rmp_tpu_torch.models.specs import (PANDA_SPEC, TWO_JOINT_SPEC, UR5_SPEC,
                                        build_model, make_dual_spec,
                                        with_fine_capsules)
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


def franka_panda() -> KinematicModel:
    """9-DOF Franka Panda (7 revolute + 2 prismatic fingers) with the
    25-capsule collision set; EE frame 'panda_grasptarget_hand'.

    RMP_PANDA_CAPS=fine swaps in the 47-primitive fine set
    (specs.with_fine_capsules). The model is cached per capsule mode, so
    the variable takes effect whenever it is set; the JAX package's
    lru_cache keeps whichever model its first call built. This departs
    from it on purpose."""
    return _franka_panda(os.environ.get("RMP_PANDA_CAPS") == "fine")


@functools.lru_cache(maxsize=None)
def _franka_panda(fine: bool) -> KinematicModel:
    return build_model(with_fine_capsules(PANDA_SPEC) if fine else PANDA_SPEC)


@functools.lru_cache(maxsize=None)
def ur5() -> KinematicModel:
    """6-DOF UR5 (6 revolute + the fixed EE frame 'ee_fixed_joint')."""
    return build_model(UR5_SPEC)


@functools.lru_cache(maxsize=None)
def dual_panda(separation: float = 0.9) -> KinematicModel:
    """Two Panda arms on one kinematic tree ('panda_dual': 26 frames, 18
    motors), bases `separation` apart on the y axis facing each other
    (specs.make_dual_spec; links and motors prefixed L_ and R_)."""
    half = separation / 2.0
    return build_model(make_dual_spec(
        PANDA_SPEC, offset_a=(0.0, half, 0.0), offset_b=(0.0, -half, 0.0),
        yaw_a=-np.pi / 2.0, yaw_b=np.pi / 2.0))


def dual_panda_q_ready(model: KinematicModel) -> np.ndarray:
    """The dual-arm Panda's ready pose: each motor takes the single Panda's
    ready value of its unprefixed joint. The motor order interleaves the
    arms (BFS over the tree), so the values map by name, never by
    position."""
    by_name = dict(zip(franka_panda().motor_names, PANDA_Q_READY))
    return np.asarray([by_name[name[2:]] for name in model.motor_names],
                      np.float32)
