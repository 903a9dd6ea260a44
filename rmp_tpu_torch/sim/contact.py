"""Contact dynamics, batched: penalty forces and hard (impulse) contacts.

The port's `rmp_tpu/sim/contact.py`. Contacts are taken at the closed-form
closest points of every collision primitive (a capsule) against every
obstacle and against the ground plane z = 0, and mapped to joint torques or
impulses through the contact points' Jacobians. Each env has C = P K + P
contacts (P primitives, K obstacles) in the JAX package's order: the
obstacle contacts primitive-major, then the ground contacts.

The FK derivatives (T, Ṫ, ∂T/∂q) come from `ops/cuda_fk.
fk_derivatives_batched`, so on the card every call launches K3. The rest is
plain PyTorch, as the JAX package computes it in XLA; the projected
Gauss-Seidel of the impulse model updates the rows of each env one after
another, and the envs side by side.
"""
from __future__ import annotations

import dataclasses

import torch

from rmp_tpu_torch.models.urdf import KinematicModel
from rmp_tpu_torch.ops.cuda_fk import fk_derivatives_batched
from rmp_tpu_torch.sim.collision import (ObstacleSet, _primitive_tables,
                                         capsule_capsule_query,
                                         link_world_capsules_all)


@dataclasses.dataclass(frozen=True)
class ContactParams:
    # sized for explicit semi-implicit Euler at dt ~ 5-10 ms: the penalty
    # spring's dt sqrt(k/m) must stay well below 1
    stiffness: float = 2000.0      # N/m penalty spring
    damping: float = 50.0          # N s/m normal damper
    friction: float = 0.5          # Coulomb-like tangential coefficient
    ground: bool = True            # include the plane z = 0


def _contacts(model: KinematicModel, q: torch.Tensor, qd: torch.Tensor,
              obstacles: ObstacleSet | None, ground: bool):
    """Every candidate contact of q, qd (B, n): (point on the link
    (B, C, 3), normal (B, C, 3), depth (B, C), positive on penetration,
    point velocity v (B, C, 3) and Jacobian J (B, C, 3, n)).

    The point is frozen in its frame's local coordinates o, solved from
    T o = [p; 1] (detached, the JAX package's stop-gradient); then
    v = (Ṫ o)[:3] and J[:, j] = (∂T/∂q_j o)[:3]."""
    T16, Td16, J16, _ = fk_derivatives_batched(model, q, qd)
    B, F = T16.shape[:2]
    n = model.n_q
    T_all = T16.reshape(B, F, 4, 4)
    p0, p1, radius, _ = link_world_capsules_all(model, T_all)
    owners = _primitive_tables(model, q.device, q.dtype)[0]   # (P,) frames
    P = p0.shape[1]
    points, normals, depths, frames = [], [], [], []
    if obstacles is not None and obstacles.count > 0:
        K = obstacles.count
        pos_l, _, normal, dist = capsule_capsule_query(
            p0[:, :, None].expand(B, P, K, 3),
            p1[:, :, None].expand(B, P, K, 3),
            radius[None, :, None].expand(B, P, K),
            obstacles.p0[:, None].expand(B, P, K, 3),
            obstacles.p1[:, None].expand(B, P, K, 3),
            obstacles.radius[:, None].expand(B, P, K))
        points.append(pos_l.reshape(B, P * K, 3))
        normals.append(normal.reshape(B, P * K, 3))
        depths.append(-dist.reshape(B, P * K))
        frames.append(owners.repeat_interleave(K))
    if ground:
        # capsule against the plane: its lower endpoint, less the radius
        lower = torch.where((p0[..., 2] < p1[..., 2])[..., None], p0, p1)
        point = torch.cat([lower[..., :2], lower[..., 2:] - radius[:, None]],
                          dim=-1)
        up = torch.zeros_like(point)
        up[..., 2] = 1.0
        points.append(point)
        normals.append(up)
        depths.append(radius - lower[..., 2])
        frames.append(owners)
    point = torch.cat(points, dim=1)
    normal = torch.cat(normals, dim=1)
    depth = torch.cat(depths, dim=1)
    frame = torch.cat(frames)                                   # (C,)
    C = frame.shape[0]
    T = T_all.index_select(1, frame)                           # (B, C, 4, 4)
    ph = torch.cat([point, torch.ones_like(point[..., :1])], dim=-1)
    # solve_ex: no error check, so no wait on the device
    o = torch.linalg.solve_ex(T, ph)[0].detach()               # (B, C, 4)
    v = (Td16.index_select(1, frame).reshape(B, C, 4, 4)
         @ o[..., None])[..., :3, 0]
    J = torch.einsum("bcakn,bck->bcan",
                     J16.index_select(1, frame).reshape(B, C, 4, 4, n),
                     o)[:, :, :3]
    return point, normal, depth, v, J


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def contact_torques(model: KinematicModel, q: torch.Tensor, qd: torch.Tensor,
                    obstacles: ObstacleSet | None,
                    params: ContactParams = ContactParams()) -> torch.Tensor:
    """Joint torques (B, n) from every penetrating contact: the normal
    force max(k depth - c v_n, 0) where depth > 0, the tangential force
    -μ f_n v_t / (|v_t| + 1e-4), each contact adding Jᵀ F."""
    _, normal, depth, v, J = _contacts(model, q, qd, obstacles,
                                       params.ground)
    v_n = _dot(v, normal)                                       # (B, C)
    f_n = torch.clamp(params.stiffness * depth - params.damping * v_n,
                      min=0.0)
    f_n = torch.where(depth > 0.0, f_n, torch.zeros_like(f_n))
    v_t = v - v_n[..., None] * normal
    f_t = -params.friction * f_n[..., None] * v_t / (
        torch.linalg.vector_norm(v_t, dim=-1, keepdim=True) + 1e-4)
    F = f_n[..., None] * normal + f_t                           # (B, C, 3)
    return torch.sum(torch.sum(J * F[..., None], dim=-2), dim=1)


def tangent_basis(n: torch.Tensor):
    """Two unit tangents orthogonal to the unit normals n (..., 3),
    branchless: t1 = n x ref / |n x ref| with ref = e_z unless |n_z| >= 0.9
    (then e_x), and t2 = n x t1."""
    ez = torch.zeros_like(n)
    ez[..., 2] = 1.0
    ex = torch.zeros_like(n)
    ex[..., 0] = 1.0
    ref = torch.where((torch.abs(n[..., 2]) < 0.9)[..., None], ez, ex)
    t1 = torch.linalg.cross(n, ref, dim=-1)
    t1 = t1 / (torch.linalg.vector_norm(t1, dim=-1, keepdim=True) + 1e-9)
    return t1, torch.linalg.cross(n, t1, dim=-1)


def contact_rows(model: KinematicModel, q: torch.Tensor, qd: torch.Tensor,
                 obstacles: ObstacleSet | None, ground: bool):
    """The rows of every candidate contact: (J_n (B, C, n), depth (B, C),
    v_n (B, C), J_t (B, 2C, n), v_t (B, 2C)). J_n maps q̇ to each contact's
    normal velocity (positive separating), J_t to its two tangential slip
    velocities, the two rows of a contact side by side. Inactive contacts
    are left to the solver (λ = 0)."""
    _, normal, depth, v, J = _contacts(model, q, qd, obstacles, ground)
    B, C, _, n = J.shape
    t1, t2 = tangent_basis(normal)
    J_n = torch.sum(normal[..., None] * J, dim=-2)
    J_t = torch.stack([torch.sum(t1[..., None] * J, dim=-2),
                       torch.sum(t2[..., None] * J, dim=-2)], dim=2)
    v_t = torch.stack([_dot(v, t1), _dot(v, t2)], dim=2)
    return (J_n, depth, _dot(v, normal), J_t.reshape(B, 2 * C, n),
            v_t.reshape(B, 2 * C))


def impulse_contact_velocity(model: KinematicModel, q: torch.Tensor,
                             qd: torch.Tensor, dt: float,
                             obstacles: ObstacleSet | None = None,
                             ground: bool = True,
                             restitution: float = 0.0,
                             friction: float = 0.5,
                             baumgarte: float = 0.2,
                             slop: float = 1e-3,
                             iterations: int = 12,
                             cfm: float = 1e-3,
                             return_impulses: bool = False):
    """q̇ (B, n) after the contact impulses of hard contacts with box
    friction: the velocity-level LCP v⁺ = v + A λ, 0 <= λ_n ⊥ v⁺_n + bias
    >= 0, |λ_t| <= μ λ_n, on the Delassus operator A = J M⁻¹ Jᵀ (M the
    mass matrix plus a 1e-6 ridge), by projected Gauss-Seidel: `iterations`
    sweeps, each over all normal rows, then all tangent rows. The solved
    system is regularised, (A + cfm I) λ + rhs ⊥ λ, and each row divides
    by max(A_ii, 1e-8) + cfm; the normal target carries the Baumgarte bias
    -baumgarte max(depth - slop, 0) / dt.

    return_impulses=True also returns λ (B, 3C): the normals (C), then the
    tangents (2C)."""
    from rmp_tpu_torch.sim.dynamics import mass_matrix

    J_n, depth, v_n, J_t, v_t = contact_rows(model, q, qd, obstacles, ground)
    C = J_n.shape[1]
    active = depth > 0.0
    J_all = torch.cat([J_n, J_t], dim=1)                        # (B, 3C, n)
    M = mass_matrix(model, q) + 1e-6 * torch.eye(
        model.n_q, dtype=q.dtype, device=q.device)
    MinvJT = torch.linalg.solve_ex(M, J_all.transpose(-1, -2))[0]  # (B, n, 3C)
    A = J_all @ MinvJT                                          # (B, 3C, 3C)
    diag = torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1), min=1e-8) + cfm
    bias_n = restitution * torch.clamp(v_n, max=0.0) \
        - baumgarte * torch.clamp(depth - slop, min=0.0) / dt
    rhs = torch.cat([v_n + bias_n, v_t], dim=1)                 # (B, 3C)

    # Gauss-Seidel row by row, two launches a row for the whole batch: λ is
    # a (B, 3C, 1) column and row i's update λ_i - (rhs_i + (A + cfm I)_i
    # λ) / diag_i is one batched product, -rhs_i / diag_i + G_i λ with
    # G = I - diag⁻¹ (A + cfm I); then the row is clamped into its box in
    # place. A normal row's box is [0, inf) where its contact is active,
    # else [0, 0]; a tangent row's is ±μ λ_n of its contact, whose λ_n is
    # 0 where the contact is inactive.
    eye = torch.eye(3 * C, dtype=A.dtype, device=A.device)
    G = eye - (A + cfm * eye) / diag[..., None]
    c = (-rhs / diag)[..., None]
    zero = torch.zeros_like(c[:, :C])
    hi_n = torch.where(active[..., None], float("inf"), zero)
    lam = torch.zeros_like(c)
    for _ in range(iterations):
        for i in range(C):
            new = torch.baddbmm(c[:, i:i + 1], G[:, i:i + 1], lam)
            torch.clamp(new, zero[:, i:i + 1], hi_n[:, i:i + 1],
                        out=lam[:, i:i + 1])
        for ci in range(C):
            limit = friction * lam[:, ci:ci + 1]
            low = -limit
            for i in (C + 2 * ci, C + 2 * ci + 1):    # the contact's two rows
                new = torch.baddbmm(c[:, i:i + 1], G[:, i:i + 1], lam)
                torch.clamp(new, low, limit, out=lam[:, i:i + 1])
    lam = lam[..., 0]
    qd_post = qd + (MinvJT @ lam[..., None])[..., 0]
    return (qd_post, lam) if return_impulses else qd_post
