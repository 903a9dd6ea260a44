"""Forward kinematics on batch-first tensors.

The port's `rmp_tpu/models/kinematics.py` (joint transforms, all-frame FK
with an optional base pose, single-frame FK and its position, and the
generic forward-mode derivatives of any map of q).
q: (..., n_q) with any leading batch axes.
"""
from __future__ import annotations

import torch
from torch.func import jvp, vmap

from rmp_tpu_torch.models.urdf import (PRISMATIC, REVOLUTE, ROOT,
                                       KinematicModel, model_cache)
from rmp_tpu_torch.ops import geom

_CONSTS: dict[tuple, tuple] = {}


def model_constants(model: KinematicModel, device: torch.device,
                    dtype: torch.dtype = torch.float32
                    ) -> dict[str, torch.Tensor]:
    """The model's static tables as tensors on `device`, built once per
    (model, device, dtype) so a tick copies nothing from the host."""
    def build():
        f = dict(dtype=dtype, device=device)
        return dict(
            q_gather=torch.as_tensor(
                [qi if qi >= 0 else model.n_q for qi in model.q_index],
                dtype=torch.long, device=device),
            axis=torch.as_tensor(model.axis, **f),
            T_constant=torch.as_tensor(model.T_constant, **f),
            is_rev=torch.as_tensor(
                [1.0 if t == REVOLUTE else 0.0 for t in model.joint_type],
                **f)[:, None, None],
            is_pris=torch.as_tensor(
                [1.0 if t == PRISMATIC else 0.0 for t in model.joint_type],
                **f)[:, None, None],
            q_lower=torch.as_tensor(model.q_lower, **f),
            q_upper=torch.as_tensor(model.q_upper, **f),
            velocity_limit=torch.as_tensor(model.velocity_limit, **f),
            effort_limit=torch.as_tensor(model.effort_limit, **f),
            joint_damping=torch.as_tensor(model.joint_damping, **f),
            mass=torch.as_tensor(model.mass, **f),
            com=torch.as_tensor(model.com, **f),
            inertia=torch.as_tensor(model.inertia, **f),
        )
    return model_cache(_CONSTS, model, (str(device), dtype), build)


_INDICES: dict[tuple, torch.Tensor] = {}


def frame_indices(frames, device: torch.device) -> torch.Tensor:
    """A static tuple of frame indices as a long tensor on `device`, built
    once: indexing a CUDA tensor with a Python list copies the list to the
    card on every call."""
    key = (tuple(frames), str(device))
    idx = _INDICES.get(key)
    if idx is None:
        idx = torch.as_tensor(key[0], dtype=torch.long, device=device)
        _INDICES[key] = idx
    return idx


def joint_transforms(model: KinematicModel, q: torch.Tensor) -> torch.Tensor:
    """Local parent->child transforms of all frames: (..., F, 4, 4)."""
    c = model_constants(model, q.device, q.dtype)
    q_pad = torch.cat([q, torch.zeros_like(q[..., :1])], dim=-1)
    q_frames = q_pad[..., c["q_gather"]]                      # (..., F)
    batch = q_frames.shape
    axis = c["axis"]
    R_rev = geom.rotation_matrix_from_axis_angle(axis, q_frames)
    T_rev = geom.hom(R_rev, torch.zeros(*batch, 3, dtype=q.dtype,
                                        device=q.device))
    eye3 = torch.eye(3, dtype=q.dtype, device=q.device).expand(*batch, 3, 3)
    T_pris = geom.hom(eye3, q_frames[..., None] * axis)
    T_fixed = torch.eye(4, dtype=q.dtype, device=q.device)
    is_rev, is_pris = c["is_rev"], c["is_pris"]
    T_var = is_rev * T_rev + is_pris * T_pris \
        + (1.0 - is_rev - is_pris) * T_fixed
    return c["T_constant"] @ T_var


def fk_all(model: KinematicModel, q: torch.Tensor,
           base: torch.Tensor | None = None) -> torch.Tensor:
    """World transforms of every frame: (..., F, 4, 4). base: the (4, 4)
    (or (..., 4, 4)) world pose of the robot's base, identity if None."""
    T_local = joint_transforms(model, q)
    world: list[torch.Tensor] = []
    for i, p in enumerate(model.parent):
        Ti = T_local[..., i, :, :]
        if p == ROOT:
            world.append(Ti if base is None else base @ Ti)
        else:
            world.append(world[p] @ Ti)
    return torch.stack(world, dim=-3)


def fk_frame(model: KinematicModel, q: torch.Tensor,
             frame_idx: int) -> torch.Tensor:
    """World transform of one frame (..., 4, 4); only its ancestor chain is
    computed."""
    chain = model.chain(frame_idx)
    T_local = joint_transforms(model, q)
    T = T_local[..., chain[0], :, :]
    for i in chain[1:]:
        T = T @ T_local[..., i, :, :]
    return T


def fk_position(model: KinematicModel, q: torch.Tensor,
                frame_idx: int) -> torch.Tensor:
    """World position of one frame's origin: (..., 3)."""
    return fk_frame(model, q, frame_idx)[..., :3, 3]


def differentiate(fn, q: torch.Tensor, qd: torch.Tensor):
    """(x, ẋ, J, c) of a smooth map x = fn(q), given q̇, forward mode
    throughout, nested as in the JAX package:

        x, ẋ = jvp(fn, q; q̇)
        J    = ∂fn/∂q: one jvp per joint (jacfwd), the n tangents vmapped
        c    = J̇ q̇ = ∂(J q̇)/∂q q̇: a jvp of the jvp

    q, qd: (..., n). fn maps each configuration on its own (a batch row
    never reads another), so the basis tangent e_k, the same in every row,
    gives column k of every row's Jacobian. fn may return a tensor or a
    tuple of them; each x (..., d) gets J (..., d, n)."""
    x, xd = jvp(fn, (q,), (qd,))
    n = q.shape[-1]
    basis = torch.eye(n, dtype=q.dtype, device=q.device).reshape(
        n, *(1,) * (q.dim() - 1), n).expand(n, *q.shape)
    J = vmap(lambda v: jvp(fn, (q,), (v,))[1], out_dims=-1)(basis)
    _, c = jvp(lambda qq: jvp(fn, (qq,), (qd,))[1], (q,), (qd,))
    return x, xd, J, c


def fk_differentiate(model: KinematicModel, q: torch.Tensor,
                     qd: torch.Tensor, frame_idx: int):
    """(x16, ẋ16, J (16, n), c16) of the flattened world 4x4 of one frame,
    each with q's leading axes, by `differentiate`."""
    def fn(qq):
        return fk_frame(model, qq, frame_idx).reshape(*qq.shape[:-1], 16)
    return differentiate(fn, q, qd)
