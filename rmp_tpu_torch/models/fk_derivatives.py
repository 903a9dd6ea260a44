"""Closed-form FK derivatives via world-frame twist generators, batched.

The port's `rmp_tpu/models/fk_derivatives.py`, and the plain PyTorch version
of the CUDA kernel in ops/cuda_fk.py. Let T_k(q) be the world transform of
frame k and, for joint j with parent-side rigid transform
A_j = T_parent(j) @ T_const_j,

    G_j = A_j E_j A_j^{-1}            (world twist generator, 4x4)

with E_j = [[skew(axis), 0], [0, 0]] (revolute) or [[0, axis], [0, 0]]
(prismatic). Then for any descendant frame k of joint j:

    ∂T_k/∂q_j = G_j T_k                                    (Jacobian columns)
    Ṫ_k       = W_k T_k,      W_k = W_parent + q̇_j G_j     (velocity)
    T̈_k|q̈=0  = (Ẇ_k + W_k W_k) T_k                        (curvature)
    Ẇ_k       = Ẇ_parent + q̇_k [W_parent(k), G_k]          (generator drift)
"""
from __future__ import annotations

import torch

from rmp_tpu_torch.models.kinematics import joint_transforms, model_constants
from rmp_tpu_torch.models.urdf import FIXED, REVOLUTE, ROOT, KinematicModel
from rmp_tpu_torch.ops import geom


def _generator(model: KinematicModel, i: int, A: torch.Tensor):
    """World twist generator G_i = A E_i A^{-1} (..., 4, 4); None for fixed."""
    jt = model.joint_type[i]
    if jt == FIXED:
        return None
    x, y, z = (float(a) for a in model.axis[i])
    E = torch.zeros(4, 4, dtype=A.dtype, device=A.device)
    if jt == REVOLUTE:
        E[:3, :3] = torch.tensor([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])
    else:  # PRISMATIC
        E[:3, 3] = torch.tensor([x, y, z])
    return (A @ E) @ geom.hom_inverse(A)


def fk_derivatives(model: KinematicModel, q: torch.Tensor, qd: torch.Tensor):
    """(T16, Td16, J16, c16): (B, F, 16), (B, F, 16), (B, F, 16, n),
    (B, F, 16) for q, qd (B, n) — the contract of the K3 kernel."""
    fkd = FkDerivatives(model, q, qd)
    T, Td, J, c = zip(*(fkd.full_row(k) for k in range(model.n_frames)))
    return (torch.stack(T, dim=-2), torch.stack(Td, dim=-2),
            torch.stack(J, dim=-3), torch.stack(c, dim=-2))


class FkDerivatives:
    """The shared FK-derivative recursion and the per-frame products
    `full_row(k)` built from it. Per frame k: T[k] world transform, W[k]
    velocity operator, Wd[k] its drift (each (..., 4, 4)), G[k] world twist
    generator (None for a fixed joint)."""

    def __init__(self, model: KinematicModel, q: torch.Tensor,
                 qd: torch.Tensor):
        F = model.n_frames
        n = model.n_q
        T_local = joint_transforms(model, q)
        T_const = model_constants(model, q.device, q.dtype)["T_constant"]
        qd_pad = torch.cat([qd, torch.zeros_like(qd[..., :1])], dim=-1)
        idx = [i if i >= 0 else n for i in model.q_index]

        batch = q.shape[:-1]
        eye = torch.eye(4, dtype=q.dtype, device=q.device).expand(*batch, 4, 4)
        zero = torch.zeros(*batch, 4, 4, dtype=q.dtype, device=q.device)

        T = [None] * F      # world transforms
        W = [None] * F      # velocity operators: Ṫ_k = W_k T_k
        Wd = [None] * F     # their drifts:       Ẇ_k
        G = [None] * F      # per-joint world generators (None for fixed)

        for i in range(F):
            p = model.parent[i]
            T_par = eye if p == ROOT else T[p]
            W_par = zero if p == ROOT else W[p]
            Wd_par = zero if p == ROOT else Wd[p]

            A = T_par @ T_const[i]
            T[i] = T_par @ T_local[..., i, :, :]
            Gi = _generator(model, i, A)
            G[i] = Gi
            if Gi is None:
                W[i] = W_par
                Wd[i] = Wd_par
            else:
                qd_i = qd_pad[..., idx[i], None, None]
                W[i] = W_par + qd_i * Gi
                Wd[i] = Wd_par + qd_i * (W_par @ Gi - Gi @ W_par)

        self.model = model
        self.n = n
        self.T, self.W, self.Wd, self.G = T, W, Wd, G

    @property
    def T16(self) -> torch.Tensor:
        """All world transforms as per-frame rows: (..., F, 16)."""
        return torch.stack([t.reshape(*t.shape[:-2], 16) for t in self.T],
                           dim=-2)

    def full_row(self, k: int):
        """(T16, Td16, J16 (.., 16, n), c16) for frame k."""
        model, n = self.model, self.n
        T, W, Wd, G = self.T, self.W, self.Wd, self.G
        batch = T[k].shape[:-2]
        Td16 = (W[k] @ T[k]).reshape(*batch, 16)
        c16 = ((Wd[k] + W[k] @ W[k]) @ T[k]).reshape(*batch, 16)
        zero16 = torch.zeros(*batch, 16, dtype=T[k].dtype, device=T[k].device)
        anc = {model.q_index[j]: j for j in model.chain(k)
               if G[j] is not None}
        cols = [(G[anc[m]] @ T[k]).reshape(*batch, 16) if m in anc else zero16
                for m in range(n)]
        return (T[k].reshape(*batch, 16), Td16, torch.stack(cols, dim=-1), c16)
