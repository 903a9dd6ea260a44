"""v2 policy set (RMP2-style), batched.

The port's `rmp_tpu/policies/v2.py`, formulas unchanged, including the
JointVelocityCap metric weight / (1 - diag(ratio²)): an elementwise division
of the scalar by the full matrix, which leaves `weight` on every
off-diagonal entry and can make the combined metric indefinite (which is
why the resolve is a pivoted LU, not a Cholesky solve).

Leaves take x, ẋ (B, P, d). A scalar param is a Python float shared by
the batch or, where a scene binds it per env (the attractor's gains and
metric scalars, the obstacle policy's repulsion gain, metric scalar and
margin, the c-space bias's metric scalar and position gain), a (B,) tensor;
a goal is a (d,) tensor shared by the batch or a (B, d) tensor of per-env
goals. The velocity cap's params stay Python floats.
"""
from __future__ import annotations

import numpy as np
import torch

from rmp_tpu_torch.policies.base import Policy, per_env, per_env_scalar
from rmp_tpu_torch.taskmaps import identity


def _eye_like(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    return torch.eye(n, dtype=x.dtype, device=x.device).expand(
        *x.shape[:-1], n, n)


def _attractor_accel_metric(params, x, xd, ctx):
    goal, eps = per_env(params["goal"]), params["accel_norm_eps"]
    delta = goal - x                                          # (B, P, d)
    delta_norm = torch.linalg.vector_norm(delta, dim=-1, keepdim=True)
    soft = torch.clamp(delta_norm, min=eps / 10.0)
    delta_hat = delta / soft

    p_gain = per_env_scalar(params["accel_p_gain"], 3)
    a = p_gain * delta / (delta_norm + eps) \
        - per_env_scalar(params["accel_d_gain"], 3) * xd

    eye = _eye_like(x)
    S = delta_hat[..., :, None] * delta_hat[..., None, :]
    scaled = delta_norm / params["metric_alpha_length_scale"]
    alpha = (1.0 - params["min_metric_alpha"]) * torch.exp(-0.5 * scaled * scaled) \
        + params["min_metric_alpha"]                          # (B, P, 1)
    alpha = alpha[..., None]                                  # (B, P, 1, 1)
    M = alpha * per_env_scalar(params["max_metric_scalar"], 4) * eye \
        + (1.0 - alpha) * per_env_scalar(params["min_metric_scalar"], 4) * S

    boost_scaled = delta_norm / params["proximity_metric_boost_length_scale"]
    boost_a = torch.exp(-0.5 * boost_scaled * boost_scaled)
    boost = boost_a * params["proximity_metric_boost_scalar"] + (1.0 - boost_a)
    M = boost[..., None] * M
    return a, M


def target_attractor(goal, taskmap, accel_p_gain, accel_d_gain,
                     accel_norm_eps, metric_alpha_length_scale,
                     min_metric_alpha, max_metric_scalar, min_metric_scalar,
                     proximity_metric_boost_scalar,
                     proximity_metric_boost_length_scale,
                     name="attractor", device=None) -> Policy:
    params = dict(goal=torch.as_tensor(goal, dtype=torch.float32,
                                       device=device),
                  accel_p_gain=accel_p_gain, accel_d_gain=accel_d_gain,
                  accel_norm_eps=accel_norm_eps,
                  metric_alpha_length_scale=metric_alpha_length_scale,
                  min_metric_alpha=min_metric_alpha,
                  max_metric_scalar=max_metric_scalar,
                  min_metric_scalar=min_metric_scalar,
                  proximity_metric_boost_scalar=proximity_metric_boost_scalar,
                  proximity_metric_boost_length_scale=proximity_metric_boost_length_scale)
    return Policy(name, taskmap, _attractor_accel_metric, params)


def _velocity_cap_accel_metric(params, x, xd, ctx):
    # the metric w / (1 - ratio^2) is singular at |xd| = max_velocity -
    # region (ratio = -1) and strongly negative nearby (reference quirk).
    # At the clip 1 - ratio^2 is ~1e-5, so one rounding of ratio moves M by
    # up to 1%. The rounding is therefore the reference's: the scalar gains
    # are combined in x's precision (the JAX rollout traces them as float32),
    # and ratio is a true division (CUDA divides by a host scalar as a
    # reciprocal multiply).
    eps = 1e-6
    for k in ("velocity_damping_region", "max_velocity", "damping_gain",
              "metric_weight"):
        if isinstance(params[k], torch.Tensor):
            raise TypeError(f"the velocity cap's {k} must be a Python "
                            f"float, got a tensor")
    s = np.float32 if xd.dtype == torch.float32 else np.float64
    region = s(params["velocity_damping_region"])
    cutoff = float(s(params["max_velocity"]) - region)
    delta_v = torch.abs(xd) - cutoff                          # (B, P, n)
    a = -torch.abs(params["damping_gain"] * delta_v) * torch.sign(xd)
    clipped = torch.clamp(delta_v, max=float(region - s(eps)))
    ratio = clipped / clipped.new_full((1,), float(region))
    diag = ratio[..., :, None] ** 2 * _eye_like(x)
    M = params["metric_weight"] / (1.0 - diag)
    a = torch.where(torch.abs(xd) < cutoff, torch.zeros_like(a), a)
    return a, M


def joint_velocity_cap(max_velocity, velocity_damping_region, damping_gain,
                       metric_weight, name="joint_velocity_cap") -> Policy:
    params = dict(max_velocity=max_velocity,
                  velocity_damping_region=velocity_damping_region,
                  damping_gain=damping_gain, metric_weight=metric_weight)
    return Policy(name, identity(), _velocity_cap_accel_metric, params,
                  static_params=tuple(params))


def _joint_damping_accel_metric(params, x, xd, ctx):
    xd_norm = torch.linalg.vector_norm(xd, dim=-1, keepdim=True)  # (B, P, 1)
    a = -(params["accel_d_gain"] * xd_norm) * xd
    scalar = params["metric_scalar"] * xd_norm[..., None]     # (B, P, 1, 1)
    M = _eye_like(x) * (scalar + params["inertia"])
    return a, M


def joint_damping(accel_d_gain, metric_scalar, inertia,
                  name="joint_damping") -> Policy:
    params = dict(accel_d_gain=accel_d_gain, metric_scalar=metric_scalar,
                  inertia=inertia)
    return Policy(name, identity(), _joint_damping_accel_metric, params)


def _obstacle_accel_metric(params, x, xd, ctx):
    # x: (B, P, 1) distances; 1-D task space per pair
    x = torch.clamp(x - per_env_scalar(params["margin"], 3), min=0.0)
    r = params["metric_modulation_radius"]
    far = x > r
    gate = x * x / (r * r) - 2.0 * x / r + 1.0
    gate = torch.where(far, torch.zeros_like(gate), gate)
    base = per_env_scalar(params["metric_scalar"], 3) / (
        x / params["metric_exploder_std_dev"] + params["metric_exploder_eps"])
    metric = base * gate                                      # (B, P, 1)
    a_repel = per_env_scalar(params["repulsion_gain"], 3) * torch.exp(
        -x / params["repulsion_std_dev"])
    sig = torch.sigmoid(xd / params["damping_velocity_gate_length_scale"])
    divisor = x / params["damping_std_dev"] + params["damping_robustness_eps"]
    a_damp = -(1.0 - sig) * params["damping_gain"] * xd / divisor
    a = a_repel + a_damp
    metric = torch.where(far, torch.zeros_like(metric), (1.0 - sig) * metric)
    if ctx is not None and "mask" in ctx:
        metric = metric * ctx["mask"].reshape(x.shape[0], -1)[..., None]
    M = metric[..., None]                                     # (B, P, 1, 1)
    return a, M


def obstacle_avoidance(taskmap, margin, damping_gain, damping_std_dev,
                       damping_robustness_eps,
                       damping_velocity_gate_length_scale, repulsion_gain,
                       repulsion_std_dev, metric_modulation_radius,
                       metric_scalar, metric_exploder_std_dev,
                       metric_exploder_eps, name) -> Policy:
    params = dict(margin=margin, damping_gain=damping_gain,
                  damping_std_dev=damping_std_dev,
                  damping_robustness_eps=damping_robustness_eps,
                  damping_velocity_gate_length_scale=damping_velocity_gate_length_scale,
                  repulsion_gain=repulsion_gain,
                  repulsion_std_dev=repulsion_std_dev,
                  metric_modulation_radius=metric_modulation_radius,
                  metric_scalar=metric_scalar,
                  metric_exploder_std_dev=metric_exploder_std_dev,
                  metric_exploder_eps=metric_exploder_eps)
    return Policy(name, taskmap, _obstacle_accel_metric, params)


def _cspace_biasing_accel_metric(params, x, xd, ctx):
    x = x - per_env(params["goal"])
    x_norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    x_hat = x / torch.clamp(x_norm, min=1e-12)
    thresh = params["robust_position_term_thresh"]
    gain = per_env_scalar(params["position_gain"], 3)
    a_pos = torch.where(x_norm < thresh, -x * gain, -thresh * x_hat * gain)
    a = a_pos - params["damping_gain"] * xd
    M = _eye_like(x) * (per_env_scalar(params["metric_scalar"], 4)
                        + params["inertia"])
    return a, M


def cspace_biasing(goal, metric_scalar, position_gain, damping_gain,
                   robust_position_term_thresh, inertia, taskmap=None,
                   name="cspace_target", device=None) -> Policy:
    params = dict(goal=torch.as_tensor(goal, dtype=torch.float32,
                                       device=device),
                  metric_scalar=metric_scalar, position_gain=position_gain,
                  damping_gain=damping_gain,
                  robust_position_term_thresh=robust_position_term_thresh,
                  inertia=inertia)
    return Policy(name, taskmap if taskmap is not None else identity(),
                  _cspace_biasing_accel_metric, params)
