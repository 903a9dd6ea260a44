"""K3: batched closed-form FK derivatives, the CUDA counterpart of
`rmp_tpu/ops/pallas_fk.py`.

`fk_derivatives_batched(model, q, qd)` returns (T16 (B, F, 16),
Td16 (B, F, 16), J16 (B, F, 16, n), c16 (B, F, 16)). A CPU tensor takes the
plain PyTorch version (models/fk_derivatives.fk_derivatives); a CUDA tensor
launches the kernel of csrc/fk_derivatives.cu or raises. Unlike the TPU
kernel, the batch needs no particular multiple. The kernel takes models of
up to 72 frames and 64 motors (`TILES`: up to 32 frames and 18 motors
the narrow kernel of that file, past them up to 40 frames and 32 motors
the wide kernel of csrc/fk_derivatives_wide.cuh, and past those that
kernel instantiated at 72 frames and 64 motors, csrc/fk_derivatives_xl.cu);
a larger model raises ValueError on a CUDA tensor before anything is
allocated or launched (`check_capacity`). Every call goes through K3's torch.library op
(ops/library.py) on the model's tables (`model_tables`): its CUDA
implementation is `launch`, the kernel's one launch site, its CPU one
`plain_of_tables`, the plain version of the model the tables describe.

Gradients: while q or q̇ requires grad, the call goes through
`FkDerivatives`, a torch.autograd.Function on both devices. Its forward is
the same kernel (or plain version); its backward is the vjp of the plain
version, recomputed from the saved q, q̇, as the JAX package differentiates
its XLA path and never its Pallas FK. Cotangents may arrive for any subset
of the four outputs.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from rmp_tpu_torch import _build
from rmp_tpu_torch.models.fk_derivatives import fk_derivatives
from rmp_tpu_torch.models.urdf import FIXED, KinematicModel, model_cache

_TABLES: dict[tuple, tuple] = {}
_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 13
# csrc/fk_derivatives.cu's kTiles, first fit first: (frames, motors, envs
# per CTA) of the narrow kernel and of the wide one's two instantiations
TILES = ((32, 18, 8), (40, 32, 4), (72, 64, 2))


def tile_of(model: KinematicModel) -> tuple[int, int, int] | None:
    """The instantiation of the kernel that serves `model`, or None."""
    return next((t for t in TILES
                 if model.n_frames <= t[0] and model.n_q <= t[1]), None)


def check_capacity(model: KinematicModel) -> None:
    """Raise ValueError when no instantiation of the kernel takes the
    model (more than 72 frames or 64 motors)."""
    if tile_of(model) is None:
        raise ValueError(
            f"model {model.name!r} ({model.n_frames} frames, {model.n_q} "
            f"motors) exceeds the K3 kernel's capacity ({TILES[-1][0]} "
            f"frames, {TILES[-1][1]} motors)")


def ancestor_table(model: KinematicModel) -> np.ndarray:
    """anc[f, m]: the actuated ancestor frame of f (f included) driven by
    motor m, or -1 — the Jacobian column m of frame f is G_anc T_f."""
    anc = np.full((model.n_frames, model.n_q), -1, np.int32)
    for f in range(model.n_frames):
        for j in model.chain(f):
            if model.joint_type[j] != FIXED:
                anc[f, model.q_index[j]] = j
    return anc


def model_tables(model: KinematicModel, device) -> dict[str, torch.Tensor]:
    """The model's static tables as the kernel reads them, built once per
    (model, device)."""
    def build():
        i32 = dict(dtype=torch.int32, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        return dict(
            parent=torch.as_tensor(model.parent, **i32),
            joint_type=torch.as_tensor(model.joint_type, **i32),
            q_index=torch.as_tensor(model.q_index, **i32),
            axis=torch.as_tensor(model.axis, **f32).contiguous(),
            T_constant=torch.as_tensor(model.T_constant, **f32)
            .reshape(model.n_frames, 16).contiguous(),
            anc=torch.as_tensor(ancestor_table(model), **i32).contiguous(),
        )
    return model_cache(_TABLES, model, (str(device),), build)


def fk_derivatives_batched(model: KinematicModel, q: torch.Tensor,
                           qd: torch.Tensor):
    """(T16, Td16, J16, c16) of every frame for q, qd (B, n) float32."""
    if torch.is_grad_enabled() and (q.requires_grad or qd.requires_grad):
        return FkDerivatives.apply(model, q, qd)
    return _forward(model, q, qd)


class FkDerivatives(torch.autograd.Function):
    """K3 with a backward: the vjp of the plain version at the saved q, q̇
    (the recomputed forward's graph lives only inside the backward)."""

    @staticmethod
    def forward(ctx, model, q, qd):
        ctx.model = model
        ctx.save_for_backward(q, qd)
        ctx.set_materialize_grads(False)
        return _forward(model, q, qd)

    @staticmethod
    def backward(ctx, *cotangents):
        q, qd = ctx.saved_tensors
        want = ctx.needs_input_grad[1:]
        pairs = [(i, g) for i, g in enumerate(cotangents) if g is not None]
        if not pairs or not any(want):
            return None, None, None
        with torch.enable_grad():
            inputs = (q.detach().requires_grad_(want[0]),
                      qd.detach().requires_grad_(want[1]))
            outs = fk_derivatives(ctx.model, *inputs)
            wrt = [x for x, w in zip(inputs, want) if w]
            grads = iter(torch.autograd.grad(
                [outs[i] for i, _ in pairs], wrt, [g for _, g in pairs],
                allow_unused=True))
        return (None,) + tuple(next(grads) if w else None for w in want)


def _forward(model: KinematicModel, q: torch.Tensor, qd: torch.Tensor):
    """K3's forward on the device of q through K3's op (ops/library.py):
    the plain version on the CPU, the kernel on CUDA (counted), raising on
    anything else."""
    n = model.n_q
    if q.dtype != torch.float32 or qd.dtype != torch.float32:
        raise TypeError(f"fk_derivatives_batched takes float32, got "
                        f"{q.dtype} and {qd.dtype}")
    if q.dim() != 2 or q.shape[1] != n or qd.shape != q.shape:
        raise ValueError(f"q and qd must both be (B, {n}), got "
                         f"{tuple(q.shape)} and {tuple(qd.shape)}")
    if q.device != qd.device:
        raise ValueError(f"q on {q.device} but qd on {qd.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no K3 kernel for device {q.device}")
    if q.device.type == "cuda":
        check_capacity(model)
    from rmp_tpu_torch.ops import library
    tab = model_tables(model, q.device)
    return library.fk_derivatives(q, qd, *(tab[k] for k in TABLES),
                                  model.n_frames, n)


# the model's tables in the order K3's op takes them
TABLES = ("parent", "joint_type", "q_index", "axis", "T_constant", "anc")
_TABLE_MODELS: dict[tuple, KinematicModel] = {}


def model_of_tables(parent, joint_type, q_index, axis, T_constant,
                    n: int) -> KinematicModel:
    """The kinematic model that K3's tables describe: what the plain
    version reads (parent, joint types, motor indices, axes and constant
    transforms, in float32 as the kernel reads them), every other field
    empty. One model per distinct table content."""
    host = [t.detach().cpu().contiguous() for t in
            (parent, joint_type, q_index, axis, T_constant)]
    key = (n, b"".join(t.numpy().tobytes() for t in host))
    model = _TABLE_MODELS.get(key)
    if model is None:
        parent, joint_type, q_index, axis, T_constant = (
            t.numpy() for t in host)
        F = parent.shape[0]
        zeros = np.zeros(n)
        model = _TABLE_MODELS[key] = KinematicModel(
            name="K3 tables", frame_names=tuple(f"frame{i}" for i in range(F)),
            link_names=tuple(f"link{i}" for i in range(F)),
            parent=tuple(int(x) for x in parent),
            joint_type=tuple(int(x) for x in joint_type),
            q_index=tuple(int(x) for x in q_index),
            motor_names=tuple(f"motor{i}" for i in range(n)),
            T_constant=T_constant.astype(np.float64).reshape(F, 4, 4),
            axis=axis.astype(np.float64), mass=np.zeros(F),
            com=np.zeros((F, 3)), inertia=np.zeros((F, 3, 3)),
            q_lower=zeros, q_upper=zeros, velocity_limit=zeros,
            effort_limit=zeros, joint_damping=zeros, joint_friction=zeros,
            has_collision=(False,) * F, collision=((),) * F)
    return model


def plain_of_tables(q, qd, parent, joint_type, q_index, axis, T_constant,
                    anc, F: int, n: int):
    """The plain version on K3's op operands (CPU tensors), bit for bit
    `fk_derivatives(model, q, qd)` of the model the tables came from."""
    del anc, F             # the plain version walks each frame's chain
    model = model_of_tables(parent, joint_type, q_index, axis, T_constant,
                            n)
    return tuple(x.contiguous() for x in fk_derivatives(model, q, qd))


def launch(q, qd, parent, joint_type, q_index, axis, T_constant, anc,
           F: int, n: int):
    """(T16, Td16, J16, c16) from K3's CUDA kernel: one launch, counted on
    fk_derivatives_batched.launches. Raises for a model beyond the
    kernel's capacity, for operands it does not take and for a failed
    launch."""
    if q.device.type != "cuda":
        raise ValueError(f"no K3 kernel for device {q.device}")
    if not (q.is_contiguous() and qd.is_contiguous()):
        raise ValueError("q and qd must be contiguous")
    B = q.shape[0]
    # separate allocations: views of one buffer would reach the policies'
    # forward-mode jvp as a primal and a tangent that share a base, which
    # PyTorch then copies (4 fills and 4 copies per tick)
    T16 = torch.empty(B, F, 16, dtype=torch.float32, device=q.device)
    Td16 = torch.empty_like(T16)
    c16 = torch.empty_like(T16)
    J16 = torch.empty(B, F, 16, n, dtype=torch.float32, device=q.device)
    fn = _build.c_function("rmp_fk_derivatives_f32", _ARGTYPES)
    rc = fn(q.device.index, B, F, n, parent.data_ptr(),
            joint_type.data_ptr(), q_index.data_ptr(), axis.data_ptr(),
            T_constant.data_ptr(), anc.data_ptr(), q.data_ptr(),
            qd.data_ptr(), T16.data_ptr(), Td16.data_ptr(), J16.data_ptr(),
            c16.data_ptr(), _build.raw_stream(q.device))
    if rc == -1:
        raise ValueError(f"a model of {F} frames and {n} motors exceeds the "
                         f"K3 kernel's capacity")
    if rc != 0:
        raise RuntimeError(f"K3 fk_derivatives launch failed: CUDA error {rc}")
    fk_derivatives_batched.launches += 1
    return T16, Td16, J16, c16


fk_derivatives_batched.launches = 0
