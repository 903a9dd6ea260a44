"""SE(3) and rotation math on tensors with any leading batch axes (fp32).

The port's `rmp_tpu/ops/geom.py`: the JAX package's `mm`/`mv` lowering
tricks for the TPU become plain `@` here. The conversions (euler,
quaternion) are written so that their forward-mode derivatives are the JAX
package's too: taskmaps differentiate through them."""
from __future__ import annotations

import torch


def mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product: (..., m, k) x (..., k) -> (..., m)."""
    return (a @ v.unsqueeze(-1)).squeeze(-1)


def _stack33(entries, batch_shape) -> torch.Tensor:
    return torch.stack(entries, dim=-1).reshape(*batch_shape, 3, 3)


def rot_x(angle: torch.Tensor) -> torch.Tensor:
    """Rotation about x. angle: (...,) -> (..., 3, 3)."""
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _stack33([o, z, z, z, c, -s, z, s, c], angle.shape)


def rot_y(angle: torch.Tensor) -> torch.Tensor:
    """Rotation about y. angle: (...,) -> (..., 3, 3)."""
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _stack33([c, z, s, z, o, z, -s, z, c], angle.shape)


def rot_z(angle: torch.Tensor) -> torch.Tensor:
    """Rotation about z. angle: (...,) -> (..., 3, 3)."""
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _stack33([c, -s, z, s, c, z, z, z, o], angle.shape)


def hom(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Homogeneous transform from R (..., 3, 3) and t (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(*batch, 3, 3)
    t = t.expand(*batch, 3)
    Rt = torch.cat([R, t.unsqueeze(-1)], dim=-1)
    bottom = torch.zeros(*batch, 1, 4, dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([Rt, bottom], dim=-2)


def hom_inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform (..., 4, 4) without a general solve."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return hom(Rt, -mv(Rt, T[..., :3, 3]))


def transform_point(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) rigid transforms to points (..., 3)."""
    return mv(T[..., :3, :3], p) + T[..., :3, 3]


def rotation_matrix_from_axis_angle(axis: torch.Tensor,
                                    angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula. axis (..., 3) (unit or zero), angle (...,) ->
    (..., 3, 3). A zero axis gives the identity (fixed joints)."""
    c = torch.cos(angle)[..., None, None]
    s = torch.sin(angle)[..., None, None]
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = torch.zeros_like(x)
    skew = _stack33([zero, -z, y, z, zero, -x, -y, x, zero], axis.shape[:-1])
    outer = axis[..., :, None] * axis[..., None, :]
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device).expand_as(outer)
    R = c * eye + s * skew + (1.0 - c) * outer
    axis_norm_sq = torch.sum(axis * axis, dim=-1)[..., None, None]
    return torch.where(axis_norm_sq > 0.5, R, eye)


def rotation_matrix_from_rpy(rpy: torch.Tensor) -> torch.Tensor:
    """URDF rpy (..., 3) -> (..., 3, 3), composed R_x(roll) @ R_y(pitch) @
    R_z(yaw): the reference's order, which coincides with extrinsic XYZ for
    the single-axis rpy values of its assets."""
    roll, pitch, yaw = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    return rot_x(roll) @ rot_y(pitch) @ rot_z(yaw)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched matrix product (..., m, k) x (..., k, n) -> (..., m, n)."""
    return a @ b


def rotate_vector(T_or_R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors (..., 3) by the rotation part of T (4x4) or R (3x3)."""
    return mv(T_or_R[..., :3, :3], v)


def euler_from_rotation_matrix(R: torch.Tensor) -> torch.Tensor:
    """Extrinsic-XYZ (roll, pitch, yaw) of R (..., 3, 3) -> (..., 3). Near
    gimbal lock (|cos pitch| < 1e-6) the divisions take 1 instead."""
    r00, r10, r20 = R[..., 0, 0], R[..., 1, 0], R[..., 2, 0]
    r21, r22 = R[..., 2, 1], R[..., 2, 2]
    theta_y = -torch.asin(torch.clamp(r20, -1.0, 1.0))
    cos_y = torch.cos(theta_y)
    safe_cos_y = torch.where(torch.abs(cos_y) < 1e-6, torch.ones_like(cos_y),
                             cos_y)
    theta_z = torch.atan2(r10 / safe_cos_y, r00 / safe_cos_y)
    theta_x = torch.atan2(r21 / safe_cos_y, r22 / safe_cos_y)
    return torch.stack([theta_x, theta_y, theta_z], dim=-1)


def rotation_matrix_from_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4), ordered (x, y, z, w) as PyBullet's, -> (..., 3, 3).
    Need not be unit; a zero quaternion gives the identity."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = torch.where(n > 0, 2.0 / torch.clamp(n, min=1e-12),
                    torch.zeros_like(n))
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    return _stack33([1.0 - (yy + zz), xy - wz, xz + wy,
                     xy + wz, 1.0 - (xx + zz), yz - wx,
                     xz - wy, yz + wx, 1.0 - (xx + yy)], q.shape[:-1])


def _safe_sqrt(v: torch.Tensor) -> torch.Tensor:
    """sqrt(max(v, 1e-12)), guarded on the input: the square root never sees
    an argument at or below 1e-12, so neither its value nor its derivative
    there is infinite or NaN (a guard on the output, where(v > 0,
    sqrt(v), 0), still differentiates sqrt at 0)."""
    return torch.sqrt(torch.where(v > 1e-12, v, torch.full_like(v, 1e-12)))


def quaternion_from_rotation_matrix(R: torch.Tensor) -> torch.Tensor:
    """Shepperd's method, branch-free: R (..., 3, 3) -> (..., 4) as (x, y, z,
    w) with w >= 0. All four candidates are formed and the one of the largest
    of (trace, r00, r11, r22) is kept (the first on a tie)."""
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    trace = r00 + r11 + r22
    s0 = 0.5 * _safe_sqrt(1.0 + trace)
    q0 = torch.stack([(r21 - r12) / (4 * s0), (r02 - r20) / (4 * s0),
                      (r10 - r01) / (4 * s0), s0], dim=-1)
    s1 = 0.5 * _safe_sqrt(1.0 + 2 * r00 - trace)
    q1 = torch.stack([s1, (r10 + r01) / (4 * s1), (r02 + r20) / (4 * s1),
                      (r21 - r12) / (4 * s1)], dim=-1)
    s2 = 0.5 * _safe_sqrt(1.0 + 2 * r11 - trace)
    q2 = torch.stack([(r10 + r01) / (4 * s2), s2, (r21 + r12) / (4 * s2),
                      (r02 - r20) / (4 * s2)], dim=-1)
    s3 = 0.5 * _safe_sqrt(1.0 + 2 * r22 - trace)
    q3 = torch.stack([(r02 + r20) / (4 * s3), (r21 + r12) / (4 * s3), s3,
                      (r10 - r01) / (4 * s3)], dim=-1)
    cands = torch.stack([q0, q1, q2, q3], dim=-2)             # (..., 4, 4)
    best = torch.argmax(torch.stack([trace, r00, r11, r22], dim=-1), dim=-1)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    return torch.where(q[..., 3:4] < 0, -q, q)


def angular_velocity_to_euler_rates_matrix(eulers: torch.Tensor
                                           ) -> torch.Tensor:
    """H(euler) (..., 3, 3) with euler rates = H ω (world angular velocity)
    for extrinsic-XYZ eulers (..., 3): the inverse of the matrix that maps
    euler rates to ω."""
    beta, gamma = eulers[..., 1], eulers[..., 2]
    sb, cb = torch.sin(beta), torch.cos(beta)
    sg, cg = torch.sin(gamma), torch.cos(gamma)
    z, o = torch.zeros_like(cb), torch.ones_like(cb)
    H = _stack33([cb * cg, -sg, z, cb * sg, cg, z, -sb, z, o],
                 eulers.shape[:-1])
    return torch.linalg.inv(H)
