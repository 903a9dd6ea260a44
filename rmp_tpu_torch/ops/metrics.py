"""RMP metric helpers of the v1 policies, batch-first.

The port's `rmp_tpu/ops/metrics.py`: the soft norm, the directionally
stretched metric and the cubic proximity weight, on tensors with any leading
axes (..., d).
"""
from __future__ import annotations

import torch


def soft_norm(v: torch.Tensor, c: float) -> torch.Tensor:
    """v / h(|v|) with h(z) = z + (1/c) log(1 + exp(-2 c z)): a smooth
    normalisation whose output goes to 0 at v = 0 (h(0) = log(2) / c)."""
    z = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    h = z + (1.0 / c) * torch.log1p(torch.exp(-2.0 * c * z))
    return v / h


def directionally_stretched_metric(v: torch.Tensor, beta, c: float
                                   ) -> torch.Tensor:
    """H = beta zeta zetaᵀ + (1 - beta) I with zeta = soft_norm(v, c).

    v: (..., d) -> (..., d, d); beta a float or a (...,) tensor."""
    zeta = soft_norm(v, c)
    outer = zeta[..., :, None] * zeta[..., None, :]
    eye = torch.eye(v.shape[-1], dtype=v.dtype, device=v.device).expand(
        outer.shape)
    if isinstance(beta, torch.Tensor):
        beta = beta[..., None, None]
    return beta * outer + (1.0 - beta) * eye


def cubic_spline_weight(d: torch.Tensor, r: float) -> torch.Tensor:
    """w(d): the cubic with w(0) = 1, w'(0) = 0, w(r) = 0, w'(r) = 0, and 0
    beyond r."""
    spline = (2.0 / r**3) * d**3 + (-3.0 / r**2) * d**2 + 1.0
    return torch.where(d > r, torch.zeros_like(spline), spline)
