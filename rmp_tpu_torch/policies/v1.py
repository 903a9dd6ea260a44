"""v1 policy set (Ratliff-2018-style RMPs), batched.

The port's `rmp_tpu/policies/v1.py`: target attraction, collision avoidance,
configuration-space biasing and joint-limit avoidance, formulas unchanged,
including two reference quirks that move trajectories:

- JointLimitAvoidance multiplies its per-joint weight into the stretched
  metric along the last axis only, M[i, j] = w[j] H[i, j]: an asymmetric
  metric;
- the target's soft norm is h = z + c log(1 + exp(-2 c z)), a `c*` factor,
  while ops/metrics.soft_norm uses 1/c.

Leaves take x, ẋ (B, P, d). Scalar gains are Python floats; a goal or a
limit vector is a (d,) tensor shared by the batch or a (B, d) tensor of
per-env values.
"""
from __future__ import annotations

import numpy as np
import torch

from rmp_tpu_torch.ops.metrics import (cubic_spline_weight,
                                       directionally_stretched_metric)
from rmp_tpu_torch.policies.base import Policy, per_env
from rmp_tpu_torch.taskmaps import identity


def _f32(x, device):
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _target_accel_metric(params, x, xd, ctx):
    goal, c = per_env(params["goal"]), params["c"]
    v = goal - x                                              # (B, P, d)
    z = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    h = z + c * torch.log1p(torch.exp(-2.0 * c * z))          # c*, not 1/c
    a = params["alpha"] * (v / h) - params["beta"] * xd
    dist = torch.linalg.vector_norm(x - goal, dim=-1)         # (B, P)
    beta_dir = 1.0 - torch.exp(-0.5 * dist**2 / params["sigma_H"] ** 2)
    H = directionally_stretched_metric(a, beta=beta_dir, c=c)
    w = torch.exp(-dist / params["sigma_w"])
    return a, w[..., None, None] * H


def target_policy(goal, taskmap, alpha, beta, c, name="Target_RMP",
                  sigma_H=1.0, sigma_w=3.0, device=None) -> Policy:
    """Soft-norm attractor with a directionally stretched metric."""
    params = dict(goal=_f32(goal, device), alpha=alpha, beta=beta, c=c,
                  sigma_H=sigma_H, sigma_w=sigma_w)
    return Policy(name, taskmap, _target_accel_metric, params)


def _collision_accel_metric(params, x, xd, ctx):
    B = x.shape[0]
    d = ctx["distance"].reshape(B, -1)                        # (B, P)
    vec = ctx["normal"].reshape(B, -1, 3)                     # (B, P, 3)
    f_rep = (params["eta_rep"] * torch.exp(-d / params["nu_rep"]))[..., None] \
        * vec
    alpha_damp = params["eta_damp"] / (d / params["nu_damp"] + 1e-6)
    scaling = torch.clamp(torch.sum(-xd * vec, dim=-1), min=0.0)
    # P_obs ẋ with P_obs = scaling vec vecᵀ, written as scaling (vec·ẋ) vec
    f_damp = (alpha_damp * scaling * torch.sum(vec * xd, dim=-1))[..., None] \
        * vec
    a = f_rep - f_damp
    w = cubic_spline_weight(d, params["r"])
    if "mask" in ctx:
        w = w * ctx["mask"].reshape(B, -1)
    H = directionally_stretched_metric(a, beta=0.0, c=params["c"])
    return a, w[..., None, None] * H


def collision_avoidance(taskmap, eta_rep, nu_rep, eta_damp, nu_damp, r, c,
                        name="collision_avoidance") -> Policy:
    """Exponential repulsion and directional damping in task space; each
    pair's distance and contact normal come from the policy's ctx."""
    params = dict(eta_rep=eta_rep, nu_rep=nu_rep, eta_damp=eta_damp,
                  nu_damp=nu_damp, r=r, c=c)
    return Policy(name, taskmap, _collision_accel_metric, params)


def _cspace_bias_accel_metric(params, x, xd, ctx):
    a = params["gamma_p"] * (per_env(params["q0"]) - x) \
        - params["gamma_d"] * xd
    n = x.shape[-1]
    M = params["w"] * torch.eye(n, dtype=x.dtype, device=x.device).expand(
        *x.shape[:-1], n, n)
    return a, M


def configuration_space_biasing(q0, gamma_p, gamma_d, name, w=0.05,
                                device=None) -> Policy:
    """PD pull toward a preferred configuration with the constant metric
    w I."""
    params = dict(q0=_f32(q0, device), gamma_p=gamma_p, gamma_d=gamma_d, w=w)
    return Policy(name, identity(), _cspace_bias_accel_metric, params)


_QD_MAX = 20.0 * (2.0 * np.pi) / 60.0                        # 20 rpm


def _joint_limit_accel_metric(params, q, qd, ctx):
    low, high = per_env(params["lower"]), per_env(params["upper"])
    d_upper = (high - q) / (high - low)
    d_lower = (q - low) / (high - low)
    w = cubic_spline_weight(torch.minimum(d_upper, d_lower), 0.15)  # (B, P, n)
    H = directionally_stretched_metric(qd / _QD_MAX, beta=0.9, c=5.0)
    # the reference's broadcast: w[j] multiplies column j of H (asymmetric)
    M = w[..., None, :] * H
    a = -params["gamma_p"] * q - params["gamma_d"] * qd
    return a, M


def joint_limit_avoidance(lower_limits, upper_limits, gamma_p, gamma_d,
                          name="joint_limit_avoidance", device=None) -> Policy:
    """Joint-limit repulsion on the identity taskmap, weighted by the
    normalised distance to the nearer limit."""
    params = dict(lower=_f32(lower_limits, device),
                  upper=_f32(upper_limits, device), gamma_p=gamma_p,
                  gamma_d=gamma_d)
    return Policy(name, identity(), _joint_limit_accel_metric, params)
