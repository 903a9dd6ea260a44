"""SE(3) and rotation math on tensors with any leading batch axes (fp32).

The port's `rmp_tpu/ops/geom.py`: the JAX package's `mm`/`mv` lowering
tricks for the TPU become plain `@` and einsum here."""
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
