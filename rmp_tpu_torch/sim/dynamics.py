"""Articulated rigid-body dynamics and integration, batched.

The port's `rmp_tpu/sim/dynamics.py`:

  inverse_dynamics   recursive Newton-Euler (RNEA) in link coordinates,
                     unrolled over the static joint tree, gravity entering
                     as a fictitious base acceleration -g, plus the URDF
                     joint damping
  mass_matrix        the ID trick M[:, j] = ID(q, 0, e_j) with gravity off,
                     the n columns as one more batch axis
  mass_matrix_crba   the Composite Rigid Body Algorithm, an independent
                     cross-check
  forward_dynamics   q̈ = (M + 1e-6 I)⁻¹ (τ - h), by torch.linalg.solve_ex
                     (the JAX package calls jnp.linalg.solve outside any
                     kernel)
  semi_implicit_euler_step  PyBullet's integrator, velocity then position

Every function takes q, q̇, q̈ or τ with any leading batch axes (..., n).
"""
from __future__ import annotations

import numpy as np
import torch

from rmp_tpu_torch.models.kinematics import (fk_all, joint_transforms,
                                             model_constants)
from rmp_tpu_torch.models.urdf import (FIXED, PRISMATIC, REVOLUTE, ROOT,
                                       KinematicModel)
from rmp_tpu_torch.ops import geom

GRAVITY = np.asarray([0.0, 0.0, -9.81], dtype=np.float32)


def _cross(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def _per_frame(model: KinematicModel, v: torch.Tensor) -> torch.Tensor:
    """Motor-ordered (..., n) values as per-frame (..., F), 0 on fixed
    frames."""
    c = model_constants(model, v.device, v.dtype)
    return torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)[
        ..., c["q_gather"]]


_GRAVITY: dict[tuple, torch.Tensor] = {}


def _gravity(device, dtype) -> torch.Tensor:
    """GRAVITY as a tensor on `device`, built once per (device, dtype): a
    copy from the host each call would wait on the device."""
    key = (str(device), dtype)
    g = _GRAVITY.get(key)
    if g is None:
        g = _GRAVITY[key] = torch.as_tensor(GRAVITY, dtype=dtype,
                                            device=device)
    return g


def inverse_dynamics(model: KinematicModel, q: torch.Tensor,
                     qd: torch.Tensor, qdd: torch.Tensor,
                     gravity=None) -> torch.Tensor:
    """Joint torques τ (..., n) that realise q̈ at (q, q̇): RNEA.

    Fixed joints pass velocities and forces on and add no DOF. gravity:
    (3,) or (..., 3), default GRAVITY."""
    c = model_constants(model, q.device, q.dtype)
    g = (_gravity(q.device, q.dtype) if gravity is None else
         torch.as_tensor(gravity, dtype=q.dtype, device=q.device))
    batch = q.shape[:-1]
    F = model.n_frames
    T_local = joint_transforms(model, q)                      # (..., F, 4, 4)
    qd_f, qdd_f = _per_frame(model, qd), _per_frame(model, qdd)
    axis, com, inertia, mass = c["axis"], c["com"], c["inertia"], c["mass"]
    zero = torch.zeros(*batch, 3, dtype=q.dtype, device=q.device)

    omega, omegad, a_lin = [None] * F, [None] * F, [None] * F
    for i in range(F):                                        # forward sweep
        p = model.parent[i]
        iRp = T_local[..., i, :3, :3].transpose(-1, -2)
        r = T_local[..., i, :3, 3]
        if p == ROOT:
            w_p, wd_p, a_p = zero, zero, (-g).expand(*batch, 3)
        else:
            w_p, wd_p, a_p = omega[p], omegad[p], a_lin[p]
        ac = geom.mv(iRp, a_p + _cross(wd_p, r) + _cross(w_p, _cross(w_p, r)))
        w_i = geom.mv(iRp, w_p)
        wd_i = geom.mv(iRp, wd_p)
        jt = model.joint_type[i]
        if jt == REVOLUTE:
            motion = qd_f[..., i, None] * axis[i]
            wd_i = wd_i + qdd_f[..., i, None] * axis[i] + _cross(w_i, motion)
            w_i = w_i + motion
        elif jt == PRISMATIC:
            ac = ac + 2.0 * _cross(w_i, qd_f[..., i, None] * axis[i]) \
                + qdd_f[..., i, None] * axis[i]
        omega[i], omegad[i], a_lin[i] = w_i, wd_i, ac

    f_tot, n_tot = [None] * F, [None] * F
    for i in reversed(range(F)):          # body wrenches, then the children's
        ci = com[i]
        a_com = a_lin[i] + _cross(omegad[i], ci) \
            + _cross(omega[i], _cross(omega[i], ci))
        fi = mass[i] * a_com
        ni = geom.mv(inertia[i], omegad[i]) \
            + _cross(omega[i], geom.mv(inertia[i], omega[i])) + _cross(ci, fi)
        for ch in (k for k, pk in enumerate(model.parent) if pk == i):
            R_ic = T_local[..., ch, :3, :3]
            f_ch = geom.mv(R_ic, f_tot[ch])
            fi = fi + f_ch
            ni = ni + geom.mv(R_ic, n_tot[ch]) \
                + _cross(T_local[..., ch, :3, 3], f_ch)
        f_tot[i], n_tot[i] = fi, ni

    tau = [None] * model.n_q
    for i in range(F):
        jt = model.joint_type[i]
        if jt != FIXED:
            wrench = n_tot[i] if jt == REVOLUTE else f_tot[i]
            tau[model.q_index[i]] = torch.sum(axis[i] * wrench, dim=-1)
    # URDF joint damping (viscous), which PyBullet applies implicitly
    return torch.stack(tau, dim=-1) + c["joint_damping"] * qd


def bias_forces(model: KinematicModel, q: torch.Tensor, qd: torch.Tensor,
                gravity=None) -> torch.Tensor:
    """h(q, q̇) = C(q, q̇) q̇ + g(q): the torques at zero acceleration."""
    return inverse_dynamics(model, q, qd, torch.zeros_like(q), gravity)


def mass_matrix(model: KinematicModel, q: torch.Tensor) -> torch.Tensor:
    """Joint-space inertia M(q) (..., n, n) by the ID trick: column j is
    ID(q, 0, e_j) with gravity off, all n columns in one call."""
    n = model.n_q
    q_cols = q[..., None, :].expand(*q.shape[:-1], n, n)
    eye = torch.eye(n, dtype=q.dtype, device=q.device).expand_as(q_cols)
    cols = inverse_dynamics(model, q_cols, torch.zeros_like(q_cols), eye,
                            gravity=torch.zeros(3, dtype=q.dtype,
                                                device=q.device))
    return cols.transpose(-1, -2)


def _skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([zero, -z, y, z, zero, -x, -y, x, zero],
                       dim=-1).reshape(*v.shape[:-1], 3, 3)


def mass_matrix_crba(model: KinematicModel, q: torch.Tensor) -> torch.Tensor:
    """Joint-space inertia by the Composite Rigid Body Algorithm, world
    frame: each body's spatial inertia about the origin is summed up the
    tree into composite inertias I^c, and M[i, j] = S_iᵀ I^c S_j over
    ancestor pairs, S the world-frame motion subspace of a joint."""
    c = model_constants(model, q.device, q.dtype)
    F, n = model.n_frames, model.n_q
    T = fk_all(model, q)                                      # (..., F, 4, 4)
    R, p = T[..., :3, :3], T[..., :3, 3]
    m = c["mass"][:, None, None]
    com_w = p + geom.mv(R, c["com"])
    I_w = R @ c["inertia"] @ R.transpose(-1, -2)
    cx = _skew(com_w)                                         # (..., F, 3, 3)
    cxT = cx.transpose(-1, -2)
    eye3 = torch.eye(3, dtype=q.dtype, device=q.device).expand_as(cx)
    I_spatial = torch.cat([torch.cat([I_w + m * (cx @ cxT), m * cx], dim=-1),
                           torch.cat([m * cxT, m * eye3], dim=-1)], dim=-2)
    Ic = [I_spatial[..., f, :, :] for f in range(F)]
    for f in reversed(range(F)):
        if model.parent[f] != ROOT:
            Ic[model.parent[f]] = Ic[model.parent[f]] + Ic[f]

    S = [None] * F                       # motion subspaces [omega; v_origin]
    for f in range(F):
        if model.joint_type[f] == FIXED:
            continue
        axis_w = geom.mv(R[..., f, :, :], c["axis"][f])
        lin = (_cross(p[..., f, :], axis_w) if model.joint_type[f] == REVOLUTE
               else axis_w)
        ang = axis_w if model.joint_type[f] == REVOLUTE \
            else torch.zeros_like(axis_w)
        S[f] = torch.cat([ang, lin], dim=-1)

    zero = torch.zeros(q.shape[:-1], dtype=q.dtype, device=q.device)
    M = [[zero] * n for _ in range(n)]
    for f in range(F):
        if S[f] is None:
            continue
        i = model.q_index[f]
        force = geom.mv(Ic[f], S[f])                          # of subtree f
        for a in model.chain(f):
            if S[a] is not None:
                j = model.q_index[a]
                M[i][j] = M[j][i] = torch.sum(S[a] * force, dim=-1)
    return torch.stack([torch.stack(row, dim=-1) for row in M], dim=-2)


def forward_dynamics(model: KinematicModel, q: torch.Tensor,
                     qd: torch.Tensor, tau: torch.Tensor,
                     gravity=None) -> torch.Tensor:
    """q̈ = M(q)⁻¹ (τ - h(q, q̇)); a 1e-6 ridge keeps the near-massless
    finger DOFs well posed in float32."""
    M = mass_matrix(model, q)
    M = M + 1e-6 * torch.eye(model.n_q, dtype=q.dtype, device=q.device)
    h = bias_forces(model, q, qd, gravity)
    # solve_ex: the LU of torch.linalg.solve without its error check, which
    # would wait on the device every call
    return torch.linalg.solve_ex(M, tau - h)[0]


def semi_implicit_euler_step(model: KinematicModel, q: torch.Tensor,
                             qd: torch.Tensor, qdd: torch.Tensor, dt: float,
                             enforce_limits: bool = True,
                             enforce_velocity_limits: bool = False):
    """PyBullet-style integration: q̇ += q̈ dt; q += q̇ dt; hard joint limits
    (position clamp + outward-velocity zeroing). q, qd, qdd: (..., n).

    enforce_velocity_limits clamps q̇ to the URDF velocity limits first. It
    is off by default: PyBullet does not enforce them under torque control,
    and the goldens were made without it."""
    c = model_constants(model, q.device, q.dtype)
    qd_new = qd + qdd * dt
    if enforce_velocity_limits:
        vmax = c["velocity_limit"]
        qd_new = torch.clamp(qd_new, -vmax, vmax)
    q_new = q + qd_new * dt
    if enforce_limits:
        low, high = c["q_lower"], c["q_upper"]
        below = q_new < low
        above = q_new > high
        q_new = torch.clamp(q_new, low, high)
        zero = torch.zeros_like(qd_new)
        qd_new = torch.where(below & (qd_new < 0), zero, qd_new)
        qd_new = torch.where(above & (qd_new > 0), zero, qd_new)
    return q_new, qd_new
