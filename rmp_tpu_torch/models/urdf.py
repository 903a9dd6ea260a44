"""Static kinematic model: the numpy constants every batched function reads.

The port's copy of `rmp_tpu/models/urdf.py`: joint-type codes, collision
primitives, `KinematicModel`, the Rx·Ry·Rz rpy composition, URDF parsing
(`parse_urdf`, `with_collision_primitives`) and PyBullet's collision-shape
inertia. The shipped robots are built from the spec tables in
`models/specs.py`; `parse_urdf` of the committed `assets/*.urdf` gives the
same models.
"""
from __future__ import annotations

import dataclasses
from typing import Callable
from xml.etree import ElementTree

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


def _floats(s: str) -> list[float]:
    return [float(x) for x in s.split()]


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


def _parse_inertial(link_elem) -> tuple[float, np.ndarray, np.ndarray]:
    inertial = link_elem.find("inertial")
    if inertial is None:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    origin = inertial.find("origin")
    xyz = np.array(_floats(origin.get("xyz", "0 0 0"))) if origin is not None else np.zeros(3)
    rpy = np.array(_floats(origin.get("rpy", "0 0 0"))) if origin is not None else np.zeros(3)
    mass = float(inertial.find("mass").get("value"))
    in_el = inertial.find("inertia")
    ixx = float(in_el.get("ixx", 0)); iyy = float(in_el.get("iyy", 0)); izz = float(in_el.get("izz", 0))
    ixy = float(in_el.get("ixy", 0)); ixz = float(in_el.get("ixz", 0)); iyz = float(in_el.get("iyz", 0))
    I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
    R = _rpy_matrix(rpy)
    return mass, xyz, R @ I @ R.T


def _parse_collision(link_elem) -> tuple[CollisionPrimitive, ...]:
    prims = []
    for col in link_elem.findall("collision"):
        geom = col.find("geometry")
        if geom is None:
            continue
        origin = col.find("origin")
        xyz = np.array(_floats(origin.get("xyz", "0 0 0"))) if origin is not None else np.zeros(3)
        rpy = np.array(_floats(origin.get("rpy", "0 0 0"))) if origin is not None else np.zeros(3)
        R = _rpy_matrix(rpy)
        sphere = geom.find("sphere")
        cylinder = geom.find("cylinder")
        box = geom.find("box")
        if sphere is not None:
            r = float(sphere.get("radius"))
            prims.append(CollisionPrimitive("sphere", tuple(xyz), tuple(xyz), r))
        elif cylinder is not None:
            r = float(cylinder.get("radius"))
            h = float(cylinder.get("length"))
            axis = R @ np.array([0.0, 0.0, h / 2])
            prims.append(
                CollisionPrimitive("capsule", tuple(xyz - axis), tuple(xyz + axis), r))
        elif box is not None:
            size = np.array(_floats(box.get("size")))
            # capsule along the longest box axis, radius = half of second-longest
            order = np.argsort(size)[::-1]
            half = size[order[0]] / 2
            radius = size[order[1]] / 2
            seg = np.zeros(3)
            seg[order[0]] = half - radius if half > radius else 0.0
            prims.append(
                CollisionPrimitive("capsule", tuple(xyz - R @ seg), tuple(xyz + R @ seg),
                                   float(radius)))
        else:
            # mesh: no analytic primitive; caller may override via
            # robots.with_collision_capsules(...)
            continue
    return tuple(prims)


def parse_urdf(filepath: str, motor_order: tuple[str, ...] | None = None) -> KinematicModel:
    """Parse a URDF into a static KinematicModel.

    motor_order: joint-name ordering of the actuated q-vector. Defaults to
    document order of non-fixed joints (which is PyBullet's motor order for
    the shipped assets — reference helper/pybullet_helper.py:8-19).
    """
    tree = ElementTree.parse(filepath)
    root = tree.getroot()
    links = {l.get("name"): l for l in root.findall("link")}
    joints = root.findall("joint")

    child_links = {j.find("child").get("link") for j in joints}
    root_link = next(n for n in links if n not in child_links)

    # BFS from root link, children in document order (matches reference
    # UrdfTree._build, helper/urdf_parsing.py:57-97)
    order: list = []
    todo = [root_link]
    while todo:
        link_name = todo.pop(0)
        for j in joints:
            if j.find("parent").get("link") == link_name:
                order.append(j)
                todo.append(j.find("child").get("link"))

    frame_names, link_names, parents, jtypes, axes = [], [], [], [], []
    T_const, masses, coms, inertias, has_col, collisions = [], [], [], [], [], []
    limits = {}
    link_to_frame = {root_link: ROOT}
    for j in order:
        name = j.get("name")
        child = j.find("child").get("link")
        parent_link = j.find("parent").get("link")
        jtype = _JOINT_TYPES[j.get("type")]
        origin = j.find("origin")
        xyz = np.array(_floats(origin.get("xyz", "0 0 0"))) if origin is not None else np.zeros(3)
        rpy = np.array(_floats(origin.get("rpy", "0 0 0"))) if origin is not None else np.zeros(3)
        axis_el = j.find("axis")
        axis = (np.array(_floats(axis_el.get("xyz"))) if (axis_el is not None and jtype != FIXED)
                else np.zeros(3))
        limit_el = j.find("limit")
        dyn_el = j.find("dynamics")
        limits[name] = dict(
            lower=float(limit_el.get("lower", "-1e9")) if limit_el is not None else -1e9,
            upper=float(limit_el.get("upper", "1e9")) if limit_el is not None else 1e9,
            velocity=float(limit_el.get("velocity", "1e9")) if limit_el is not None else 1e9,
            effort=float(limit_el.get("effort", "1e9")) if limit_el is not None else 1e9,
            damping=float(dyn_el.get("damping", "0")) if dyn_el is not None else 0.0,
            friction=float(dyn_el.get("friction", "0")) if dyn_el is not None else 0.0,
        )

        frame_names.append(name)
        link_names.append(child)
        parents.append(link_to_frame[parent_link])
        link_to_frame[child] = len(frame_names) - 1
        jtypes.append(jtype)
        axes.append(axis)
        T_const.append(_hom(_rpy_matrix(rpy), xyz))
        m, c, I = _parse_inertial(links[child])
        masses.append(m)
        coms.append(c)
        inertias.append(I)
        prims = _parse_collision(links[child])
        has_col.append(links[child].find("collision") is not None)
        collisions.append(prims)

    if motor_order is None:
        motor_order = tuple(j.get("name") for j in joints
                            if _JOINT_TYPES[j.get("type")] != FIXED)
    q_index = tuple(
        motor_order.index(n) if (jt != FIXED and n in motor_order) else -1
        for n, jt in zip(frame_names, jtypes))

    return KinematicModel(
        name=root.get("name", "robot"),
        frame_names=tuple(frame_names),
        link_names=tuple(link_names),
        parent=tuple(parents),
        joint_type=tuple(jtypes),
        q_index=q_index,
        motor_names=tuple(motor_order),
        T_constant=np.asarray(T_const, dtype=np.float32),
        axis=np.asarray(axes, dtype=np.float32),
        mass=np.asarray(masses, dtype=np.float32),
        com=np.asarray(coms, dtype=np.float32),
        inertia=np.asarray(inertias, dtype=np.float32),
        q_lower=np.asarray([limits[n]["lower"] for n in motor_order], dtype=np.float32),
        q_upper=np.asarray([limits[n]["upper"] for n in motor_order], dtype=np.float32),
        velocity_limit=np.asarray([limits[n]["velocity"] for n in motor_order], dtype=np.float32),
        effort_limit=np.asarray([limits[n]["effort"] for n in motor_order], dtype=np.float32),
        joint_damping=np.asarray([limits[n]["damping"] for n in motor_order], dtype=np.float32),
        joint_friction=np.asarray([limits[n]["friction"] for n in motor_order], dtype=np.float32),
        has_collision=tuple(has_col),
        collision=tuple(collisions),
    )


def with_collision_primitives(
    model: KinematicModel,
    overrides: dict[str, tuple[CollisionPrimitive, ...]],
) -> KinematicModel:
    """Replace per-frame collision primitives (keyed by frame/joint name).

    Used for mesh-based URDFs (Franka) where analytic capsule approximations
    are supplied by hand (the spec tables of models/specs.py).
    """
    collisions = list(model.collision)
    has_col = list(model.has_collision)
    for name, prims in overrides.items():
        i = model.frame_index(name)
        collisions[i] = tuple(prims)
        has_col[i] = len(prims) > 0
    return dataclasses.replace(
        model, collision=tuple(collisions), has_collision=tuple(has_col))


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
