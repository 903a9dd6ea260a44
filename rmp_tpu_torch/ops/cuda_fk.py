"""K3: batched closed-form FK derivatives, the CUDA counterpart of
`rmp_tpu/ops/pallas_fk.py`.

`fk_derivatives_batched(model, q, qd)` returns (T16 (B, F, 16),
Td16 (B, F, 16), J16 (B, F, 16, n), c16 (B, F, 16)). A CPU tensor takes the
plain PyTorch version (models/fk_derivatives.fk_derivatives); a CUDA tensor
launches the kernel of csrc/fk_derivatives.cu or raises. Unlike the TPU
kernel, the batch needs no particular multiple.

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
    """K3's forward on the device of q: the plain version on the CPU, the
    kernel on CUDA (counted), raising on anything else."""
    n = model.n_q
    if q.dtype != torch.float32 or qd.dtype != torch.float32:
        raise TypeError(f"fk_derivatives_batched takes float32, got "
                        f"{q.dtype} and {qd.dtype}")
    if q.dim() != 2 or q.shape[1] != n or qd.shape != q.shape:
        raise ValueError(f"q and qd must both be (B, {n}), got "
                         f"{tuple(q.shape)} and {tuple(qd.shape)}")
    if q.device != qd.device:
        raise ValueError(f"q on {q.device} but qd on {qd.device}")
    if q.device.type == "cpu":
        return fk_derivatives(model, q, qd)
    if q.device.type != "cuda":
        raise ValueError(f"no K3 kernel for device {q.device}")
    if not (q.is_contiguous() and qd.is_contiguous()):
        raise ValueError("q and qd must be contiguous")

    B, F = q.shape[0], model.n_frames
    tab = model_tables(model, q.device)
    # separate allocations: views of one buffer would reach the policies'
    # forward-mode jvp as a primal and a tangent that share a base, which
    # PyTorch then copies (4 fills and 4 copies per tick)
    T16 = torch.empty(B, F, 16, dtype=torch.float32, device=q.device)
    Td16 = torch.empty_like(T16)
    c16 = torch.empty_like(T16)
    J16 = torch.empty(B, F, 16, n, dtype=torch.float32, device=q.device)
    fn = _build.c_function("rmp_fk_derivatives_f32", _ARGTYPES)
    rc = fn(q.device.index, B, F, n, tab["parent"].data_ptr(),
            tab["joint_type"].data_ptr(), tab["q_index"].data_ptr(),
            tab["axis"].data_ptr(), tab["T_constant"].data_ptr(),
            tab["anc"].data_ptr(), q.data_ptr(), qd.data_ptr(),
            T16.data_ptr(), Td16.data_ptr(), J16.data_ptr(), c16.data_ptr(),
            _build.raw_stream(q.device))
    if rc == -1:
        raise ValueError(f"model {model.name!r} ({F} frames, {n} motors) "
                         f"exceeds the K3 kernel's capacity")
    if rc != 0:
        raise RuntimeError(f"K3 fk_derivatives launch failed: CUDA error {rc}")
    fk_derivatives_batched.launches += 1
    return T16, Td16, J16, c16


fk_derivatives_batched.launches = 0
