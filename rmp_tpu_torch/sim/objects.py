"""Scene objects: robots, spheres, goals, cylinders.

The port's `rmp_tpu/sim/objects.py`: plain descriptions on numpy, after the
reference's PyBullet object hierarchy without the client plumbing; the world
state they induce is a SimState (sim/world.py). Orientation takes euler
angles (3,) or an (x, y, z, w) quaternion (4,).
"""
from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from rmp_tpu_torch.models import robots as robot_models
from rmp_tpu_torch.ops import geom
from rmp_tpu_torch.sim.collision import (ObstacleSet, cylinder_obstacle,
                                         sphere_obstacle)


def _to_euler(orientation) -> np.ndarray:
    orientation = np.asarray(orientation, dtype=np.float32)
    if orientation.shape[-1] == 4:
        R = geom.rotation_matrix_from_quaternion(torch.as_tensor(orientation))
        return geom.euler_from_rotation_matrix(R).numpy()
    return orientation


@dataclasses.dataclass
class SceneObject:
    base_position: tuple = (0.0, 0.0, 0.0)
    base_orientation: tuple = (0.0, 0.0, 0.0, 1.0)

    @property
    def euler(self) -> np.ndarray:
        return _to_euler(np.asarray(self.base_orientation))

    def as_obstacle(self, device=None) -> ObstacleSet | None:
        return None


@dataclasses.dataclass
class Sphere(SceneObject):
    radius: float = 0.1

    def as_obstacle(self, device=None) -> ObstacleSet:
        return sphere_obstacle(self.base_position, self.radius, device=device)


@dataclasses.dataclass
class Goal(Sphere):
    """A visual goal marker: no collision shape."""

    def as_obstacle(self, device=None) -> None:
        return None


@dataclasses.dataclass
class Cylinder(SceneObject):
    radius: float = 0.05
    height: float = 0.3

    def as_obstacle(self, device=None) -> ObstacleSet:
        return cylinder_obstacle(self.base_position, self.euler, self.radius,
                                 self.height, device=device)


@dataclasses.dataclass
class Robot(SceneObject):
    q: np.ndarray | None = None
    qd: np.ndarray | None = None

    # per-robot constants: ClassVar, so a subclass's class attributes take
    # effect (dataclass fields would keep the base default)
    model_fn: typing.ClassVar = None
    q_ready: typing.ClassVar[np.ndarray] = None
    q_lim_low: typing.ClassVar[np.ndarray] = None
    q_lim_high: typing.ClassVar[np.ndarray] = None

    def __post_init__(self):
        if self.q is None:
            self.q = np.array(type(self).q_ready, dtype=np.float32)
        if self.qd is None:
            self.qd = np.zeros_like(self.q)
        assert self.q.ndim == 1, "robot q must be a joint vector"

    @property
    def model(self):
        return type(self).model_fn()


@dataclasses.dataclass
class TwoJointRobot(Robot):
    q_ready = robot_models.TWO_JOINT_Q_READY
    q_lim_low = robot_models.TWO_JOINT_Q_LIM_LOW
    q_lim_high = robot_models.TWO_JOINT_Q_LIM_HIGH
    model_fn = staticmethod(robot_models.two_joint_robot)


@dataclasses.dataclass
class FrankaPanda(Robot):
    q_ready = robot_models.PANDA_Q_READY
    q_lim_low = robot_models.PANDA_Q_LIM_LOW
    q_lim_high = robot_models.PANDA_Q_LIM_HIGH
    model_fn = staticmethod(robot_models.franka_panda)
