"""Integration of the commanded acceleration.

The port's `rmp_tpu/sim/dynamics.py`, integrator only: the rigid-body
dynamics (RNEA, CRBA, forward dynamics) of the torque path are not ported
yet."""
from __future__ import annotations

import torch

from rmp_tpu_torch.models.kinematics import model_constants
from rmp_tpu_torch.models.urdf import KinematicModel


def semi_implicit_euler_step(model: KinematicModel, q: torch.Tensor,
                             qd: torch.Tensor, qdd: torch.Tensor, dt: float,
                             enforce_limits: bool = True):
    """PyBullet-style integration: q̇ += q̈ dt; q += q̇ dt; hard joint limits
    (position clamp + outward-velocity zeroing). q, qd, qdd: (..., n)."""
    qd_new = qd + qdd * dt
    q_new = q + qd_new * dt
    if enforce_limits:
        c = model_constants(model, q.device, q.dtype)
        low, high = c["q_lower"], c["q_upper"]
        below = q_new < low
        above = q_new > high
        q_new = torch.clamp(q_new, low, high)
        zero = torch.zeros_like(qd_new)
        qd_new = torch.where(below & (qd_new < 0), zero, qd_new)
        qd_new = torch.where(above & (qd_new > 0), zero, qd_new)
    return q_new, qd_new
