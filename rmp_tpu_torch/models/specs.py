"""Robot specifications as plain data, and the model builder.

The port's copy of the robot tables of `rmp_tpu/models/specs.py`: the
planar two-joint arm, the Panda (its link and joint table and the 25-capsule
mesh-fitted collision set, and the finer 47-primitive set behind
`with_fine_capsules`) and the UR5, the multi-robot spec transforms
(`make_multi_spec`, `make_dual_spec`) that compose copies of a spec under a
common world root, the N-link planar arm (`make_planar_arm_spec`) and URDF
export (`write_urdf`).
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


def write_urdf(spec: RobotSpec, filepath: str) -> None:
    """Serialize a RobotSpec to URDF (round-trips through
    models/urdf.parse_urdf): a capsule as a cylinder along z rotated onto
    its axis, a sphere at its centre."""
    out = [f'<?xml version="1.0"?>', f'<robot name="{spec.name}">']
    for l in spec.links:
        out.append(f'  <link name="{l.name}">')
        ixx, iyy, izz, ixy, ixz, iyz = l.inertia
        out.append("    <inertial>")
        out.append(f'      <origin xyz="{l.com[0]} {l.com[1]} {l.com[2]}" rpy="0 0 0"/>')
        out.append(f'      <mass value="{l.mass}"/>')
        out.append(f'      <inertia ixx="{ixx}" iyy="{iyy}" izz="{izz}" '
                   f'ixy="{ixy}" ixz="{ixz}" iyz="{iyz}"/>')
        out.append("    </inertial>")
        for c in l.collision:
            out.append("    <collision>")
            if c.kind == "sphere":
                out.append(f'      <origin xyz="{c.p0[0]} {c.p0[1]} {c.p0[2]}" rpy="0 0 0"/>')
                out.append(f'      <geometry><sphere radius="{c.radius}"/></geometry>')
            else:
                p0, p1 = np.array(c.p0), np.array(c.p1)
                mid = (p0 + p1) / 2
                d = p1 - p0
                length = float(np.linalg.norm(d))
                # emit as cylinder along z rotated to d (rpy about x/y only)
                if length > 0:
                    dn = d / length
                    pitch = float(np.arcsin(np.clip(dn[0], -1, 1)))
                    roll = float(np.arctan2(-dn[1], dn[2]))
                else:
                    roll = pitch = 0.0
                out.append(f'      <origin xyz="{mid[0]} {mid[1]} {mid[2]}" '
                           f'rpy="{roll} {pitch} 0"/>')
                out.append(f'      <geometry><cylinder radius="{c.radius}" '
                           f'length="{length}"/></geometry>')
            out.append("    </collision>")
        out.append("  </link>")
    for j in spec.joints:
        out.append(f'  <joint name="{j.name}" type="{j.joint_type}">')
        out.append(f'    <origin xyz="{j.xyz[0]} {j.xyz[1]} {j.xyz[2]}" '
                   f'rpy="{j.rpy[0]} {j.rpy[1]} {j.rpy[2]}"/>')
        out.append(f'    <parent link="{j.parent}"/>')
        out.append(f'    <child link="{j.child}"/>')
        if j.joint_type != "fixed":
            out.append(f'    <axis xyz="{j.axis[0]} {j.axis[1]} {j.axis[2]}"/>')
            out.append(f'    <limit lower="{j.lower}" upper="{j.upper}" '
                       f'velocity="{j.velocity}" effort="{j.effort}"/>')
            out.append(f'    <dynamics damping="{j.damping}" friction="{j.friction}"/>')
        out.append("  </joint>")
    out.append("</robot>")
    with open(filepath, "w") as f:
        f.write("\n".join(out) + "\n")


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


# The finer fitted set (47 primitives; capsule bulge <= 8.8 mm), opt-in
# through RMP_PANDA_CAPS=fine (models/robots.franka_panda): ~1.9x the
# collision pairs of the default set.
_PANDA_CAPS_FINE = {
    "panda_link1": (
        CollisionPrimitive("capsule", (-0.0003, -0.0245, 0.0066), (0.0001, -0.0386, -0.0202), 0.0548),
        CollisionPrimitive("capsule", (0.0004, -0.0201, -0.0309), (-0.0002, -0.0765, 0.0013), 0.0549),
        CollisionPrimitive("capsule", (0.0021, -0.0434, -0.0726), (-0.0080, -0.0342, -0.0742), 0.0589),
        CollisionPrimitive("capsule", (0.0025, -0.0002, -0.1504), (-0.0047, -0.0098, -0.1407), 0.0626),
        CollisionPrimitive("capsule", (-0.0154, -0.0079, -0.0676), (0.0159, -0.0027, -0.0779), 0.0428),
    ),
    "panda_link2": (
        CollisionPrimitive("capsule", (0.0009, -0.0907, 0.0433), (-0.0004, -0.0675, 0.0128), 0.0565),
        CollisionPrimitive("capsule", (0.0031, 0.0016, 0.0753), (-0.0038, -0.0030, 0.0773), 0.0537),
        CollisionPrimitive("capsule", (-0.0033, 0.0096, 0.0874), (-0.0137, 0.0048, 0.0533), 0.0411),
        CollisionPrimitive("capsule", (0.0002, -0.0274, 0.0401), (0.0002, 0.0053, 0.0232), 0.0548),
        CollisionPrimitive("capsule", (0.0021, -0.1543, 0.0005), (-0.0039, -0.1460, 0.0079), 0.0619),
    ),
    "panda_link3": (
        CollisionPrimitive("capsule", (0.0841, 0.0633, 0.0021), (0.0857, 0.0259, -0.0047), 0.0517),
        CollisionPrimitive("capsule", (0.0015, -0.0243, -0.0974), (-0.0085, 0.0051, -0.0682), 0.0380),
        CollisionPrimitive("capsule", (0.0619, 0.0356, -0.0200), (0.0206, 0.0109, -0.0720), 0.0604),
        CollisionPrimitive("capsule", (0.0853, 0.0301, 0.0126), (-0.0057, -0.0020, -0.0634), 0.0486),
        CollisionPrimitive("capsule", (-0.0267, 0.0313, -0.1019), (-0.0368, -0.0169, -0.1028), 0.0213),
    ),
    "panda_link4": (
        CollisionPrimitive("capsule", (-0.0239, 0.0234, 0.0422), (0.0028, -0.0026, 0.0244), 0.0572),
        CollisionPrimitive("capsule", (0.0059, -0.0005, 0.0645), (-0.0427, 0.0589, 0.0314), 0.0493),
        CollisionPrimitive("capsule", (-0.0103, 0.0110, 0.0393), (-0.0832, 0.0833, -0.0004), 0.0621),
        CollisionPrimitive("capsule", (-0.0016, -0.0062, 0.0661), (-0.0526, 0.0680, 0.0301), 0.0479),
    ),
    "panda_link5": (
        CollisionPrimitive("capsule", (-0.0159, 0.0010, -0.2235), (0.0076, 0.0262, -0.2079), 0.0529),
        CollisionPrimitive("capsule", (-0.0001, 0.0374, 0.0045), (0.0000, 0.0720, -0.0545), 0.0498),
        CollisionPrimitive("capsule", (0.0068, -0.0331, -0.2383), (0.0384, 0.0095, -0.2338), 0.0293),
        CollisionPrimitive("capsule", (0.0057, 0.0709, -0.0169), (-0.0060, 0.0814, 0.0023), 0.0491),
        CollisionPrimitive("capsule", (-0.0012, 0.0390, -0.1861), (0.0032, 0.0807, 0.0034), 0.0506),
        CollisionPrimitive("capsule", (0.0001, 0.0087, -0.1860), (0.0001, 0.0348, -0.0729), 0.0522),
    ),
    "panda_link6": (
        CollisionPrimitive("capsule", (-0.0122, -0.0200, 0.0112), (0.1020, -0.0273, 0.0175), 0.0292),
        CollisionPrimitive("capsule", (0.0830, 0.0346, -0.0072), (0.0720, 0.0387, 0.0035), 0.0461),
        CollisionPrimitive("capsule", (0.1003, 0.0178, 0.0159), (-0.0028, 0.0298, 0.0117), 0.0293),
        CollisionPrimitive("capsule", (0.0732, -0.0268, -0.0198), (0.1097, -0.0251, -0.0090), 0.0294),
        CollisionPrimitive("capsule", (0.0313, -0.0008, 0.0266), (-0.0191, 0.0007, 0.0174), 0.0354),
        CollisionPrimitive("capsule", (0.1050, 0.0488, -0.0003), (0.0891, 0.0532, 0.0180), 0.0254),
    ),
    "panda_link7": (
        CollisionPrimitive("capsule", (0.0234, 0.0371, 0.0796), (-0.0232, 0.0019, 0.0793), 0.0291),
        CollisionPrimitive("capsule", (0.0432, 0.0178, 0.0696), (0.0455, 0.0191, 0.0858), 0.0195),
        CollisionPrimitive("capsule", (0.0385, 0.0676, 0.0859), (-0.0285, 0.0176, 0.0594), 0.0143),
        CollisionPrimitive("capsule", (0.0698, 0.0358, 0.0856), (0.0480, 0.0599, 0.0851), 0.0126),
        CollisionPrimitive("capsule", (0.0229, -0.0103, 0.0778), (-0.0145, -0.0213, 0.0768), 0.0306),
    ),
    "panda_hand": (
        CollisionPrimitive("capsule", (0.0002, 0.0738, 0.0090), (-0.0000, 0.0793, 0.0464), 0.0260),
        CollisionPrimitive("capsule", (0.0003, -0.0827, 0.0451), (-0.0003, 0.0720, 0.0394), 0.0245),
        CollisionPrimitive("capsule", (0.0001, -0.0786, 0.0029), (0.0001, 0.0576, 0.0099), 0.0265),
    ),
    "panda_leftfinger": (
        CollisionPrimitive("capsule", (0.0090, 0.0227, 0.0045), (-0.0092, 0.0226, 0.0051), 0.0049),
        CollisionPrimitive("capsule", (0.0041, 0.0078, 0.0468), (-0.0047, 0.0071, 0.0472), 0.0091),
        CollisionPrimitive("capsule", (-0.0016, 0.0062, 0.0283), (0.0005, 0.0135, 0.0336), 0.0112),
        CollisionPrimitive("capsule", (-0.0002, 0.0197, 0.0177), (0.0002, 0.0074, 0.0051), 0.0115),
    ),
    "panda_rightfinger": (
        CollisionPrimitive("capsule", (-0.0094, -0.0225, 0.0043), (0.0094, -0.0221, 0.0051), 0.0049),
        CollisionPrimitive("capsule", (-0.0042, -0.0075, 0.0465), (0.0045, -0.0074, 0.0472), 0.0092),
        CollisionPrimitive("capsule", (0.0021, -0.0088, 0.0295), (-0.0008, -0.0122, 0.0299), 0.0133),
        CollisionPrimitive("capsule", (0.0005, -0.0197, 0.0174), (-0.0001, -0.0076, 0.0049), 0.0115),
    ),
}


def _plink(name, mass, com):
    caps = _PANDA_CAPS.get(name)
    return LinkSpec(name, mass, com, _DIAG01, caps if caps else ())


def with_fine_capsules(spec: RobotSpec) -> RobotSpec:
    """spec with every link's capsule set swapped for the fine table where
    one exists (the Panda's links; other links keep their primitives)."""
    links = tuple(
        dataclasses.replace(l, collision=_PANDA_CAPS_FINE[l.name])
        if l.name in _PANDA_CAPS_FINE else l
        for l in spec.links)
    return dataclasses.replace(spec, links=links)


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


def make_planar_arm_spec(n_links: int, link_length: float = 0.5,
                         link_mass: float = 0.4,
                         link_radius: float = 0.04) -> RobotSpec:
    """An N-link planar revolute arm (the generality helper): joints about
    z, links along x with one capsule each, a fixed 'ee_joint' at the last
    link's tip carrying a sphere. Field for field as the JAX package's."""
    izz = link_mass * link_length ** 2 / 3.0
    links = [LinkSpec("base_link")]
    joints = []
    for i in range(n_links):
        links.append(LinkSpec(
            f"link_{i + 1}", link_mass, (link_length / 2, 0, 0),
            (1e-4, izz, izz, 0, 0, 0),
            (CollisionPrimitive("capsule", (link_radius, 0, 0),
                                (link_length - link_radius, 0, 0),
                                link_radius),)))
        joints.append(JointSpec(
            f"joint_{i + 1}", "revolute",
            "base_link" if i == 0 else f"link_{i}", f"link_{i + 1}",
            xyz=(0, 0, 0.05) if i == 0 else (link_length, 0, 0),
            axis=(0, 0, 1), lower=-np.pi, upper=np.pi, velocity=5,
            effort=100))
    links.append(LinkSpec("ee", 0.05, (0, 0, 0), (1e-5,) * 3 + (0.0,) * 3,
                          (CollisionPrimitive("sphere", (0, 0, 0), (0, 0, 0),
                                              link_radius),)))
    joints.append(JointSpec("ee_joint", "fixed", f"link_{n_links}", "ee",
                            xyz=(link_length, 0, 0)))
    return RobotSpec(name=f"planar_{n_links}link", links=tuple(links),
                     joints=tuple(joints))
