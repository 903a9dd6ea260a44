"""Robot specifications as plain data, and the model builder.

The port's copy of the robot tables of `rmp_tpu/models/specs.py`: the
planar two-joint arm, the Panda (its link and joint table and the 25-capsule
mesh-fitted collision set) and the UR5, and the multi-robot spec transforms
(`make_multi_spec`, `make_dual_spec`) that compose copies of a spec under a
common world root. URDF export is not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from rmp_tpu_torch.models.urdf import (_JOINT_TYPES, ROOT, CollisionPrimitive,
                                       KinematicModel, _hom, _rpy_matrix)


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    name: str
    mass: float = 0.0
    com: tuple = (0.0, 0.0, 0.0)
    # (ixx, iyy, izz, ixy, ixz, iyz) about com, link axes
    inertia: tuple = (0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    collision: tuple = ()          # CollisionPrimitive tuple


@dataclasses.dataclass(frozen=True)
class JointSpec:
    name: str
    joint_type: str                # 'revolute' | 'prismatic' | 'fixed'
    parent: str
    child: str
    xyz: tuple = (0.0, 0.0, 0.0)
    rpy: tuple = (0.0, 0.0, 0.0)
    axis: tuple = (0.0, 0.0, 0.0)
    lower: float = -1e9
    upper: float = 1e9
    velocity: float = 1e9
    effort: float = 1e9
    damping: float = 0.0
    friction: float = 0.0


@dataclasses.dataclass(frozen=True)
class RobotSpec:
    name: str
    links: tuple
    joints: tuple


def build_model(spec: RobotSpec) -> KinematicModel:
    """Construct a KinematicModel from a RobotSpec (BFS joint order)."""
    links = {l.name: l for l in spec.links}
    child_names = {j.child for j in spec.joints}
    root_link = next(l.name for l in spec.links if l.name not in child_names)

    order: list[JointSpec] = []
    todo = [root_link]
    while todo:
        ln = todo.pop(0)
        for j in spec.joints:
            if j.parent == ln:
                order.append(j)
                todo.append(j.child)

    link_to_frame = {root_link: ROOT}
    parents = []
    for i, j in enumerate(order):
        parents.append(link_to_frame[j.parent])
        link_to_frame[j.child] = i

    motor = tuple(j.name for j in order if j.joint_type != "fixed")
    q_index = tuple(
        motor.index(j.name) if j.joint_type != "fixed" else -1 for j in order)

    def _inertia_mat(t):
        ixx, iyy, izz, ixy, ixz, iyz = t
        return np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])

    motor_specs = {j.name: j for j in order}

    def motor_column(field):
        return np.asarray([getattr(motor_specs[n], field) for n in motor],
                          dtype=np.float32)

    return KinematicModel(
        name=spec.name,
        frame_names=tuple(j.name for j in order),
        link_names=tuple(j.child for j in order),
        parent=tuple(parents),
        joint_type=tuple(_JOINT_TYPES[j.joint_type] for j in order),
        q_index=q_index,
        motor_names=motor,
        T_constant=np.asarray(
            [_hom(_rpy_matrix(np.array(j.rpy)), np.array(j.xyz)) for j in order],
            dtype=np.float32),
        axis=np.asarray([j.axis for j in order], dtype=np.float32),
        mass=np.asarray([links[j.child].mass for j in order], dtype=np.float32),
        com=np.asarray([links[j.child].com for j in order], dtype=np.float32),
        inertia=np.asarray(
            [_inertia_mat(links[j.child].inertia) for j in order],
            dtype=np.float32),
        q_lower=motor_column("lower"),
        q_upper=motor_column("upper"),
        velocity_limit=motor_column("velocity"),
        effort_limit=motor_column("effort"),
        joint_damping=motor_column("damping"),
        joint_friction=motor_column("friction"),
        has_collision=tuple(bool(links[j.child].collision) for j in order),
        collision=tuple(tuple(links[j.child].collision) for j in order),
    )


# ---------------------------------------------------------------------------
# Planar 2-DOF arm (reference asset: urdf/TwoJointRobot_wo_fixedJoints.urdf)
# ---------------------------------------------------------------------------

_BOX_I = (0.00208333333333, 0.167083333333, 0.168333333333,
          0.0125, 0.00625, 0.000625)
_CYL_I = (0.000322916666667, 0.000322916666667, 0.0005625, 0.0, 0.0, 0.0)

TWO_JOINT_SPEC = RobotSpec(
    name="TwoJointRobot",
    links=(
        LinkSpec("base_link", 0.2, (0, 0, 0), _CYL_I,
                 (CollisionPrimitive("capsule", (0, 0, 0.025), (0, 0, 0.025), 0.075),)),
        LinkSpec("link_1", 0.5, (0, 0, 0), _BOX_I,
                 (CollisionPrimitive("capsule", (0.05, 0, 0), (0.95, 0, 0), 0.05),)),
        LinkSpec("link_2", 0.5, (0, 0, 0), _BOX_I,
                 (CollisionPrimitive("capsule", (0.05, 0, 0), (0.95, 0, 0), 0.05),)),
        LinkSpec("link_23_cyl", 0.2, (0, 0, 0), _CYL_I,
                 (CollisionPrimitive("sphere", (0, 0, 0), (0, 0, 0), 0.075),)),
    ),
    joints=(
        JointSpec("joint_1", "revolute", "base_link", "link_1",
                  xyz=(0, 0, 0.075), axis=(0, 0, 1),
                  lower=-3.14, upper=3.14, velocity=5, effort=10000),
        JointSpec("joint_2", "revolute", "link_1", "link_2",
                  xyz=(1.0, 0.0, 0.05), axis=(0, 0, 1),
                  lower=-3.14, upper=3.14, velocity=5, effort=10000),
        JointSpec("link_23", "fixed", "link_2", "link_23_cyl",
                  xyz=(1.0, 0, 0)),
    ),
)

# ---------------------------------------------------------------------------
# Franka Panda (reference asset: urdf/franka_panda/panda.urdf)
# ---------------------------------------------------------------------------

_DIAG01 = (0.1, 0.1, 0.1, 0.0, 0.0, 0.0)
# Multi-capsule approximations of the Panda collision meshes, fitted per
# link (mesh protrusion <= 13 mm, capsule bulge outside the hull <= 11 mm).
_PANDA_CAPS = {
    "panda_link1": (
        CollisionPrimitive("capsule", (0.0024, -0.0000, -0.1504), (-0.0030, -0.0068, -0.1432), 0.0620),
        CollisionPrimitive("capsule", (-0.0004, -0.0323, -0.0111), (-0.0001, -0.0771, 0.0016), 0.0543),
        CollisionPrimitive("capsule", (-0.0001, -0.0131, -0.0656), (0.0005, -0.0440, -0.0883), 0.0559),
        CollisionPrimitive("capsule", (0.0005, -0.0260, -0.0016), (0.0053, -0.0344, 0.0009), 0.0569),
    ),
    "panda_link2": (
        CollisionPrimitive("capsule", (-0.0001, -0.1561, -0.0015), (-0.0001, -0.0882, 0.0411), 0.0581),
        CollisionPrimitive("capsule", (-0.0001, 0.0064, 0.0360), (0.0001, -0.1400, -0.0010), 0.0551),
        CollisionPrimitive("capsule", (-0.0021, 0.0013, 0.0785), (0.0041, -0.0034, 0.0743), 0.0528),
    ),
    "panda_link3": (
        CollisionPrimitive("capsule", (-0.0004, 0.0002, -0.0798), (0.0805, 0.0417, -0.0040), 0.0604),
        CollisionPrimitive("capsule", (0.0844, 0.0644, 0.0013), (0.0828, 0.0265, 0.0041), 0.0509),
    ),
    "panda_link4": (
        CollisionPrimitive("capsule", (-0.0111, 0.0118, 0.0392), (-0.0830, 0.0832, -0.0003), 0.0609),
        CollisionPrimitive("capsule", (0.0006, -0.0003, 0.0621), (0.0004, -0.0007, 0.0265), 0.0532),
    ),
    "panda_link5": (
        CollisionPrimitive("capsule", (-0.0049, 0.0850, 0.0056), (0.0082, 0.0811, 0.0022), 0.0471),
        CollisionPrimitive("capsule", (-0.0001, 0.0598, 0.0005), (0.0006, 0.0188, -0.2137), 0.0576),
        CollisionPrimitive("capsule", (0.0010, 0.0358, -0.1825), (-0.0018, -0.0050, -0.2254), 0.0554),
    ),
    "panda_link6": (
        CollisionPrimitive("capsule", (0.0871, 0.0463, -0.0001), (0.0219, 0.0159, 0.0164), 0.0420),
        CollisionPrimitive("capsule", (-0.0086, 0.0000, 0.0189), (0.0955, -0.0189, -0.0006), 0.0428),
    ),
    "panda_link7": (
        CollisionPrimitive("capsule", (0.0389, 0.0607, 0.0850), (-0.0268, 0.0119, 0.0647), 0.0204),
        CollisionPrimitive("capsule", (0.0055, -0.0295, 0.0896), (0.0627, 0.0393, 0.0844), 0.0186),
        CollisionPrimitive("capsule", (0.0421, 0.0213, 0.0782), (0.0002, -0.0276, 0.0698), 0.0257),
        CollisionPrimitive("capsule", (-0.0045, 0.0218, 0.0827), (-0.0219, -0.0152, 0.0782), 0.0296),
    ),
    "panda_hand": (
        CollisionPrimitive("capsule", (0.0002, 0.0738, 0.0090), (0.0001, 0.0793, 0.0464), 0.0260),
        CollisionPrimitive("capsule", (0.0001, -0.0826, 0.0450), (-0.0004, 0.0721, 0.0392), 0.0245),
        CollisionPrimitive("capsule", (0.0001, -0.0789, 0.0027), (0.0001, 0.0576, 0.0098), 0.0265),
    ),
    "panda_leftfinger": (
        CollisionPrimitive("capsule", (-0.0001, 0.0154, 0.0056), (-0.0001, 0.0081, 0.0451), 0.0118),
    ),
    "panda_rightfinger": (
        CollisionPrimitive("capsule", (0.0001, -0.0154, 0.0056), (0.0001, -0.0081, 0.0451), 0.0118),
    ),
}


def _plink(name, mass, com):
    caps = _PANDA_CAPS.get(name)
    return LinkSpec(name, mass, com, _DIAG01, caps if caps else ())


_HALF_PI = 1.57079632679

PANDA_SPEC = RobotSpec(
    name="panda",
    links=(
        _plink("panda_link0", 2.9, (0, 0, 0.5)),
        _plink("panda_link1", 2.7, (0, -0.04, -0.05)),
        _plink("panda_link2", 2.73, (0, -0.04, 0.06)),
        _plink("panda_link3", 2.04, (0.01, 0.01, -0.05)),
        _plink("panda_link4", 2.08, (-0.03, 0.03, 0.02)),
        _plink("panda_link5", 3.0, (0, 0.04, -0.12)),
        _plink("panda_link6", 1.3, (0.04, 0, 0)),
        _plink("panda_link7", 0.2, (0, 0, 0.08)),
        _plink("panda_link8", 0.0, (0, 0, 0)),
        _plink("panda_hand", 0.81, (0, 0, 0.04)),
        _plink("panda_leftfinger", 0.1, (0, 0.01, 0.02)),
        _plink("panda_rightfinger", 0.1, (0, -0.01, 0.02)),
        _plink("panda_grasptarget", 0.0, (0, 0, 0)),
    ),
    joints=(
        JointSpec("panda_joint1", "revolute", "panda_link0", "panda_link1",
                  xyz=(0, 0, 0.333), axis=(0, 0, 1),
                  lower=-2.9671, upper=2.9671, velocity=2.175, effort=87),
        JointSpec("panda_joint2", "revolute", "panda_link1", "panda_link2",
                  rpy=(-_HALF_PI, 0, 0), axis=(0, 0, 1),
                  lower=-1.8326, upper=1.8326, velocity=2.175, effort=87),
        JointSpec("panda_joint3", "revolute", "panda_link2", "panda_link3",
                  xyz=(0, -0.316, 0), rpy=(_HALF_PI, 0, 0), axis=(0, 0, 1),
                  lower=-2.9671, upper=2.9671, velocity=2.175, effort=87),
        JointSpec("panda_joint4", "revolute", "panda_link3", "panda_link4",
                  xyz=(0.0825, 0, 0), rpy=(_HALF_PI, 0, 0), axis=(0, 0, 1),
                  lower=-3.1416, upper=0.0, velocity=2.175, effort=87),
        JointSpec("panda_joint5", "revolute", "panda_link4", "panda_link5",
                  xyz=(-0.0825, 0.384, 0), rpy=(-_HALF_PI, 0, 0), axis=(0, 0, 1),
                  lower=-2.9671, upper=2.9671, velocity=2.61, effort=12),
        JointSpec("panda_joint6", "revolute", "panda_link5", "panda_link6",
                  rpy=(_HALF_PI, 0, 0), axis=(0, 0, 1),
                  lower=-0.0873, upper=3.8223, velocity=2.61, effort=12),
        JointSpec("panda_joint7", "revolute", "panda_link6", "panda_link7",
                  xyz=(0.088, 0, 0), rpy=(_HALF_PI, 0, 0), axis=(0, 0, 1),
                  lower=-2.9671, upper=2.9671, velocity=2.61, effort=12),
        JointSpec("panda_joint8", "fixed", "panda_link7", "panda_link8",
                  xyz=(0, 0, 0.107)),
        JointSpec("panda_hand_joint", "fixed", "panda_link8", "panda_hand",
                  rpy=(0, 0, -0.785398163397)),
        JointSpec("panda_finger_joint1", "prismatic", "panda_hand", "panda_leftfinger",
                  xyz=(0, 0, 0.0584), axis=(0, 1, 0),
                  lower=0.0, upper=0.04, velocity=0.2, effort=20),
        JointSpec("panda_finger_joint2", "prismatic", "panda_hand", "panda_rightfinger",
                  xyz=(0, 0, 0.0584), axis=(0, -1, 0),
                  lower=0.0, upper=0.04, velocity=0.2, effort=20),
        JointSpec("panda_grasptarget_hand", "fixed", "panda_hand", "panda_grasptarget",
                  xyz=(0, 0, 0.105)),
    ),
)


# ---------------------------------------------------------------------------
# Universal Robots UR5: kinematic frames of the public ur_description
# ur5.urdf chain; inertials approximate (diagonal, CoM at link centroids).
# ---------------------------------------------------------------------------

_HPI = 1.570796325


def _ur5_link(name, mass, com, caps):
    return LinkSpec(name, mass, com, _DIAG01, caps)


UR5_SPEC = RobotSpec(
    name="UR5",
    links=(
        LinkSpec("base_link", 4.0, (0, 0, 0), _DIAG01,
                 (CollisionPrimitive("capsule", (0, 0, 0.01), (0, 0, 0.06), 0.06),)),
        _ur5_link("shoulder_link", 3.7, (0, 0, -0.02),
                  (CollisionPrimitive("capsule", (0, 0, -0.04), (0, 0, 0.01), 0.06),)),
        _ur5_link("upper_arm_link", 8.393, (0, -0.024, 0.2125),
                  (CollisionPrimitive("capsule", (0, -0.045, 0.0), (0, -0.045, 0.425), 0.055),)),
        _ur5_link("forearm_link", 2.275, (0, 0.0, 0.196),
                  (CollisionPrimitive("capsule", (0, 0, 0.0), (0, 0, 0.39225), 0.045),)),
        _ur5_link("wrist_1_link", 1.219, (0, 0.05, 0),
                  (CollisionPrimitive("capsule", (0, 0.02, 0), (0, 0.08, 0), 0.04),)),
        _ur5_link("wrist_2_link", 1.219, (0, 0, 0.05),
                  (CollisionPrimitive("capsule", (0, 0, 0.02), (0, 0, 0.08), 0.04),)),
        _ur5_link("wrist_3_link", 0.1879, (0, 0.03, 0),
                  (CollisionPrimitive("capsule", (0, 0.01, 0), (0, 0.06, 0), 0.035),)),
        LinkSpec("ee_link", 0.0, (0, 0, 0), (0.0,) * 6, ()),
    ),
    joints=(
        JointSpec("shoulder_pan_joint", "revolute", "base_link",
                  "shoulder_link", xyz=(0, 0, 0.089159), axis=(0, 0, 1),
                  lower=-6.2832, upper=6.2832, velocity=3.15, effort=150,
                  damping=0.1),
        JointSpec("shoulder_lift_joint", "revolute", "shoulder_link",
                  "upper_arm_link", xyz=(0, 0.13585, 0), rpy=(0, _HPI, 0),
                  axis=(0, 1, 0), lower=-6.2832, upper=6.2832, velocity=3.15,
                  effort=150, damping=0.1),
        JointSpec("elbow_joint", "revolute", "upper_arm_link",
                  "forearm_link", xyz=(0, -0.1197, 0.425), axis=(0, 1, 0),
                  lower=-3.1416, upper=3.1416, velocity=3.15, effort=150,
                  damping=0.1),
        JointSpec("wrist_1_joint", "revolute", "forearm_link",
                  "wrist_1_link", xyz=(0, 0, 0.39225), rpy=(0, _HPI, 0),
                  axis=(0, 1, 0), lower=-6.2832, upper=6.2832, velocity=3.2,
                  effort=28, damping=0.1),
        JointSpec("wrist_2_joint", "revolute", "wrist_1_link",
                  "wrist_2_link", xyz=(0, 0.093, 0), axis=(0, 0, 1),
                  lower=-6.2832, upper=6.2832, velocity=3.2, effort=28,
                  damping=0.1),
        JointSpec("wrist_3_joint", "revolute", "wrist_2_link",
                  "wrist_3_link", xyz=(0, 0, 0.09465), axis=(0, 1, 0),
                  lower=-6.2832, upper=6.2832, velocity=3.2, effort=28,
                  damping=0.1),
        JointSpec("ee_fixed_joint", "fixed", "wrist_3_link", "ee_link",
                  xyz=(0, 0.0823, 0), rpy=(0, 0, _HPI)),
    ),
)


def make_multi_spec(spec: RobotSpec, offsets, yaws, prefixes,
                    name: str | None = None) -> RobotSpec:
    """N copies of a robot spec in one kinematic tree: a 'world' root link
    with a fixed base-mount joint placing each copy (its links and joints
    renamed with its prefix) at its offset and yaw. The result is an
    ordinary single-root spec, so FK, dynamics, collision and the policies
    apply to it unchanged."""
    offsets, yaws, prefixes = tuple(offsets), tuple(yaws), tuple(prefixes)
    if not (len(offsets) == len(yaws) == len(prefixes)):
        raise ValueError("offsets/yaws/prefixes must have equal lengths")
    if len(set(prefixes)) != len(prefixes):
        raise ValueError(f"duplicate prefixes: {prefixes}")
    child_names = {j.child for j in spec.joints}
    root = next(l.name for l in spec.links if l.name not in child_names)

    links: tuple = (LinkSpec("world"),)
    joints: tuple = ()
    for prefix, offset, yaw in zip(prefixes, offsets, yaws):
        links = links + tuple(dataclasses.replace(l, name=prefix + l.name)
                              for l in spec.links)
        mount = JointSpec(prefix + "base_mount", "fixed", "world",
                          prefix + root, xyz=tuple(offset),
                          rpy=(0.0, 0.0, yaw))
        joints = joints + (mount,) + tuple(dataclasses.replace(
            j, name=prefix + j.name, parent=prefix + j.parent,
            child=prefix + j.child) for j in spec.joints)
    return RobotSpec(name=name or f"{spec.name}_x{len(prefixes)}",
                     links=links, joints=joints)


def make_dual_spec(spec: RobotSpec,
                   offset_a=(0.0, 0.45, 0.0), offset_b=(0.0, -0.45, 0.0),
                   yaw_a: float = 0.0, yaw_b: float = 0.0,
                   prefix_a: str = "L_", prefix_b: str = "R_") -> RobotSpec:
    """The two-robot case of make_multi_spec (the dual-arm Panda)."""
    return make_multi_spec(spec, (offset_a, offset_b), (yaw_a, yaw_b),
                           (prefix_a, prefix_b), name=spec.name + "_dual")
