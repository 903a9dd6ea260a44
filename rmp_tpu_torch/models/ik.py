"""Inverse kinematics by damped least squares.

The port's `rmp_tpu/models/ik.py`: the iterative DLS solver that stands in
for PyBullet's calculateInverseKinematics (franka/04's start pose). It runs
on the device of its inputs, and its loop makes no host round trip.
"""
from __future__ import annotations

import torch
from torch.func import jacfwd

from rmp_tpu_torch.models import kinematics as K
from rmp_tpu_torch.models.urdf import KinematicModel
from rmp_tpu_torch.ops import geom


def _rotation_error(R_current: torch.Tensor,
                    R_target: torch.Tensor) -> torch.Tensor:
    """so(3) error vector e with R_target ≈ exp([e]x) R_current."""
    R_err = R_target @ R_current.transpose(-1, -2)
    w = torch.stack([R_err[..., 2, 1] - R_err[..., 1, 2],
                     R_err[..., 0, 2] - R_err[..., 2, 0],
                     R_err[..., 1, 0] - R_err[..., 0, 1]], dim=-1)
    # keepdim: forward-mode AD of a 0-d tensor against a Python float
    # promotes the tangent to float64 (torch 2.13), so no 0-d tensor here
    trace = R_err.diagonal(dim1=-2, dim2=-1).sum(-1, keepdim=True)
    angle = torch.acos(torch.clamp(0.5 * (trace - 1.0), -1.0, 1.0))
    scale = torch.where(angle < 1e-6, torch.full_like(angle, 0.5),
                        angle / (2.0 * torch.sin(angle) + 1e-12))
    return scale * w


def _device_of(*xs) -> torch.device:
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def inverse_kinematics(model: KinematicModel, frame: str | int,
                       target_position, target_orientation_quat=None,
                       q_init=None, iterations: int = 200,
                       damping: float = 1e-2, step_scale: float = 0.5,
                       respect_limits: bool = True) -> torch.Tensor:
    """q (n,) with fk(q)[frame] at the target position (3,) and, when given,
    orientation (an (x, y, z, w) quaternion): `iterations` DLS steps
    dq = -step_scale Jᵀ (J Jᵀ + damping² I)⁻¹ e from q_init (default zeros),
    each clipped to the joint limits. Runs on the device of the first tensor
    among target_position, target_orientation_quat and q_init (numpy
    inputs: the CPU)."""
    idx = model.frame_index(frame) if isinstance(frame, str) else frame
    f32 = dict(dtype=torch.float32,
               device=_device_of(target_position, target_orientation_quat,
                                 q_init))
    target = torch.as_tensor(target_position, **f32)
    q = (torch.zeros(model.n_q, **f32) if q_init is None
         else torch.as_tensor(q_init, **f32).clone())
    R_target = (None if target_orientation_quat is None else
                geom.rotation_matrix_from_quaternion(
                    torch.as_tensor(target_orientation_quat, **f32)))
    c = K.model_constants(model, q.device, q.dtype)

    def error(qq):
        T = K.fk_frame(model, qq, idx)
        e_pos = target - T[:3, 3]
        if R_target is None:
            return e_pos
        return torch.cat([e_pos, _rotation_error(T[:3, :3], R_target)])

    # the error itself rides along as jacfwd's aux output
    jac = jacfwd(lambda qq: (error(qq),) * 2, has_aux=True)
    for _ in range(iterations):
        J, e = jac(q)                           # (m, n); J = -d(fk)/dq
        A = J @ J.T + (damping ** 2) * torch.eye(e.shape[0], **f32)
        # solve_ex: no error check, so no wait on the device
        dq = -step_scale * (J.T @ torch.linalg.solve_ex(A, e)[0])
        q = q + dq
        if respect_limits:
            q = torch.clamp(q, c["q_lower"], c["q_upper"])
    return q
