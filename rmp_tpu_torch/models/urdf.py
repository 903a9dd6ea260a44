"""Static kinematic model: the numpy constants every batched function reads.

The port's copy of `rmp_tpu/models/urdf.py` (joint-type codes, collision
primitives, `KinematicModel`, the Rx·Ry·Rz rpy composition and PyBullet's
collision-shape inertia). URDF parsing (`parse_urdf`) is not ported yet;
robots are built from the spec tables in `models/specs.py`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

ROOT = -1
REVOLUTE = 0
PRISMATIC = 1
FIXED = 2

_JOINT_TYPES = {
    "revolute": REVOLUTE,
    "continuous": REVOLUTE,
    "prismatic": PRISMATIC,
    "fixed": FIXED,
}


def _rpy_matrix(rpy: np.ndarray) -> np.ndarray:
    """Rotation from URDF rpy, composed R_x @ R_y @ R_z.

    The composition order of the reference implementation, kept for
    trajectory parity; identical to URDF-standard extrinsic XYZ for the
    single-axis rpy values of every shipped robot."""
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rx @ Ry @ Rz


def _hom(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


@dataclasses.dataclass(frozen=True)
class CollisionPrimitive:
    """Analytic collision shape attached to a frame (link coordinates).

    kind: 'sphere' (p0, radius) or 'capsule' (segment p0->p1, radius)."""

    kind: str
    p0: tuple[float, float, float]
    p1: tuple[float, float, float]
    radius: float


@dataclasses.dataclass(frozen=True)
class KinematicModel:
    """Static robot model of numpy constants.

    Frames are joints in BFS order from the root link; frame i's transform
    maps child-link coordinates to world."""

    name: str
    frame_names: tuple[str, ...]        # (F,)
    link_names: tuple[str, ...]         # (F,) child link of each joint
    parent: tuple[int, ...]             # (F,) frame index of parent, ROOT=-1
    joint_type: tuple[int, ...]         # (F,) REVOLUTE/PRISMATIC/FIXED
    q_index: tuple[int, ...]            # (F,) motor index, -1 for fixed
    motor_names: tuple[str, ...]        # (n_q,) joint names in motor order
    T_constant: np.ndarray              # (F, 4, 4) parent->joint fixed part
    axis: np.ndarray                    # (F, 3)
    # child-link inertial data, in child-link frame:
    mass: np.ndarray                    # (F,)
    com: np.ndarray                     # (F, 3)
    inertia: np.ndarray                 # (F, 3, 3) about com, link axes
    # motor-ordered limits/dynamics:
    q_lower: np.ndarray                 # (n_q,)
    q_upper: np.ndarray                 # (n_q,)
    velocity_limit: np.ndarray          # (n_q,)
    effort_limit: np.ndarray            # (n_q,)
    joint_damping: np.ndarray           # (n_q,)
    joint_friction: np.ndarray          # (n_q,)
    has_collision: tuple[bool, ...]     # (F,) child link has collision geom
    collision: tuple[tuple[CollisionPrimitive, ...], ...]  # per frame

    @property
    def n_frames(self) -> int:
        return len(self.frame_names)

    @property
    def n_q(self) -> int:
        return len(self.motor_names)

    def frame_index(self, name: str) -> int:
        return self.frame_names.index(name)

    def chain(self, frame_idx: int) -> tuple[int, ...]:
        """Root->frame ancestor chain."""
        path = []
        i = frame_idx
        while i != ROOT:
            path.append(i)
            i = self.parent[i]
        return tuple(reversed(path))

    @property
    def collision_frames(self) -> tuple[int, ...]:
        return tuple(i for i, h in enumerate(self.has_collision) if h)


def model_cache(cache: dict, model: KinematicModel, key: tuple,
                build: Callable):
    """cache[(id(model),) + key], made by build() on first use. The entry
    holds the model itself, so its id() cannot pass to another model while
    the entry lives."""
    k = (id(model),) + key
    hit = cache.get(k)
    if hit is None:
        hit = cache[k] = (model, build())
    return hit[1]


def pybullet_collision_inertia(model: KinematicModel, hull_verts=None,
                               margin: float = 1e-3) -> KinematicModel:
    """The model with PyBullet's loadURDF inertia tensors.

    Plain loadURDF ignores the URDF <inertia> tensor and recomputes it from
    each link's collision shape, by Bullet's box-AABB approximation:

        l = AABB extent of the collision geometry + 2 margin
        I = diag(m/12 (ly² + lz², lx² + lz², lx² + ly²))

    with the importer's default margin 1e-3. Mass and COM keep their URDF
    values. Applied to every collision link from its hull vertices
    (hull_verts (L, V, 3) in collision-frame order, default the robot's
    asset, models/hulls.py); raises for a robot without one. Only
    torque-mode trajectories feel the change: in contact-free motion
    FD(ID(q̈)) = q̈ for any consistent model, so the torques change and the
    path does not."""
    if hull_verts is None:
        from rmp_tpu_torch.models.hulls import hulls_for
        hull_verts = hulls_for(model)
        if hull_verts is None:
            raise ValueError(
                f"no hull asset for robot {model.name!r}: cannot "
                "reconstruct PyBullet's collision-shape inertia")
    inertia = np.array(model.inertia)
    for row, frame in enumerate(model.collision_frames):
        verts = np.asarray(hull_verts[row], np.float64)
        ext = verts.max(axis=0) - verts.min(axis=0) + 2.0 * margin
        x2, y2, z2 = ext * ext
        m = float(model.mass[frame])
        inertia[frame] = np.diag(m / 12.0 *
                                 np.asarray([y2 + z2, x2 + z2, x2 + y2]))
    return dataclasses.replace(model, inertia=inertia.astype(np.float32))
