"""Learned RMP leaves: MLP-parameterised (accel, metric) policies, batched.

The port's `rmp_tpu/policies/neural.py`, forward only (training through the
rollout is not ported yet). The metric head emits a Cholesky factor with a
softplus diagonal, so a learned metric is symmetric PSD by construction;
the accel head is tanh-bounded and scaled. The obstacle leaf keeps the hand
leaf's task space (one signed distance per pair), its `ctx["mask"]`
protocol and its exactly-zero metric beyond the support radius. The MLPs
are tanh layers and a linear last layer computed by torch.matmul, as the
JAX package computes them outside any kernel. A net is a dict of float32
tensors 'w0', 'b0', ... (convert.net_from_numpy carries one across from
numpy); scalar params are Python floats.
"""
from __future__ import annotations

import numpy as np
import torch

from rmp_tpu_torch.policies.base import Policy, per_env


def mlp_init(gen: torch.Generator, sizes: tuple, device=None) -> dict:
    """Glorot-uniform MLP params {'w0', 'b0', ...} for the layer widths
    `sizes`, drawn from `gen` (on `device`, default the generator's)."""
    device = gen.device if device is None else torch.device(device)
    net = {}
    for i, (n_in, n_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        lim = float(np.sqrt(6.0 / (n_in + n_out)))
        u = torch.rand(n_in, n_out, generator=gen, device=gen.device)
        net[f"w{i}"] = (u * (2.0 * lim) - lim).to(device)
        net[f"b{i}"] = torch.zeros(n_out, device=device)
    return net


def mlp_apply(net: dict, h: torch.Tensor) -> torch.Tensor:
    """tanh-MLP forward with a linear final layer, over leading axes."""
    n_layers = len(net) // 2
    for i in range(n_layers):
        h = h @ net[f"w{i}"] + net[f"b{i}"]
        if i + 1 < n_layers:
            h = torch.tanh(h)
    return h


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as the JAX package computes it, logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


_BASES: dict[tuple, torch.Tensor] = {}


def _strict_lower_basis(d: int, device, dtype) -> torch.Tensor:
    """(d(d-1)/2, d d) constant that places the strict-lower entries in
    row-major order, built once per (d, device, dtype)."""
    key = (d, str(device), dtype)
    basis = _BASES.get(key)
    if basis is None:
        rows, cols = np.tril_indices(d, k=-1)
        b = np.zeros((len(rows), d * d), np.float32)
        b[np.arange(len(rows)), rows * d + cols] = 1.0
        basis = _BASES[key] = torch.as_tensor(b, dtype=dtype, device=device)
    return basis


def chol_from_raw(raw: torch.Tensor, d: int) -> torch.Tensor:
    """(..., d + d(d-1)/2) raw head outputs -> (..., d, d) lower-triangular
    L with a softplus diagonal; the strict-lower entries are placed by a
    constant basis contraction, as in the JAX package."""
    diag = softplus(raw[..., :d])
    basis = _strict_lower_basis(d, raw.device, raw.dtype)
    flat = torch.sum(raw[..., d:, None] * basis, dim=-2)
    L = flat.reshape(*raw.shape[:-1], d, d)
    eye = torch.eye(d, dtype=raw.dtype, device=raw.device)
    return L + diag[..., :, None] * eye


def head_sizes(d: int) -> int:
    """MLP output width for a d-dim task space: accel d, Cholesky diagonal
    d and strict lower d(d-1)/2."""
    return d + d + d * (d - 1) // 2


OBSTACLE_FEATURES = 3   # (x / r, exp(-x / sigma), ẋ / v_scale) per pair


def _neural_attractor_accel_metric(params, x, xd, ctx):
    d = x.shape[-1]
    goal = per_env(params["goal"])
    feats = torch.cat([goal - x, xd], dim=-1)                # (B, P, 2d)
    out = mlp_apply(params["net"], feats / params["feat_scale"])
    a = params["accel_scale"] * torch.tanh(out[..., :d])
    L = chol_from_raw(out[..., d:], d)
    M = L @ L.transpose(-1, -2)
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    M = params["metric_scale"] * (M + params["metric_eps"] * eye)
    return a, M


def _neural_obstacle_accel_metric(params, x, xd, ctx):
    # x, xd: (B, P, 1) signed distances of the grouped distance taskmap
    # and their rates; one net scores every (link, obstacle) pair
    r = params["support_radius"]
    xc = torch.clamp(x, min=0.0)         # penetration clamped for features
    feats = torch.cat([xc / r, torch.exp(-xc / params["feat_sigma"]),
                       xd / params["vel_scale"]], dim=-1)     # (B, P, 3)
    out = mlp_apply(params["net"], feats)                     # (B, P, 2)
    # the accel bound grows by repulsion_boost near contact; the metric
    # carries the hand leaf's quadratic support gate and 1/x exploder
    boost = 1.0 + params["repulsion_boost"] * torch.exp(
        -xc / params["repulsion_sigma"])
    a = params["accel_scale"] * torch.tanh(out[..., :1]) * boost
    gate = xc * xc / (r * r) - 2.0 * xc / r + 1.0
    gate = torch.where(xc > r, torch.zeros_like(gate), gate)
    exploder = 1.0 / (xc / params["metric_exploder_std_dev"]
                      + params["metric_exploder_eps"])
    metric = (params["metric_scale"] * softplus(out[..., 1:2])
              * gate * exploder)
    if ctx is not None and "mask" in ctx:
        metric = metric * ctx["mask"].reshape(x.shape[0], -1)[..., None]
    return a, metric[..., None]                               # (B, P, 1, 1)


def transparent_obstacle_init(net: dict, metric_raw: float = -4.0,
                              accel_raw: float = 0.3) -> dict:
    """The net with its final layer's weights zeroed and its bias set to
    (accel_raw, metric_raw): an input-independent start, a mild constant
    repulsion and a small metric."""
    i = len(net) // 2 - 1
    out = dict(net)
    out[f"w{i}"] = torch.zeros_like(net[f"w{i}"])
    out[f"b{i}"] = torch.tensor([accel_raw, metric_raw], dtype=torch.float32,
                                device=net[f"b{i}"].device)
    return out


def neural_obstacle(taskmap, net: dict, support_radius: float = 0.5,
                    feat_sigma: float = 0.1, vel_scale: float = 1.0,
                    accel_scale: float = 20.0, metric_scale: float = 5.0,
                    repulsion_boost: float = 0.0,
                    repulsion_sigma: float = 0.01,
                    metric_exploder_std_dev: float | None = None,
                    metric_exploder_eps: float = 0.001,
                    name: str = "neural_obstacle") -> Policy:
    """Learned obstacle-avoidance leaf on a 1-D distance taskmap, a drop-in
    for v2.obstacle_avoidance. net: mlp_init(gen, (OBSTACLE_FEATURES,
    *hidden, 2)). Without metric_exploder_std_dev the exploder is the
    identity (1 / (x / 1e9 + 1) == 1 in float32 over the support)."""
    w_last = net[f"w{len(net) // 2 - 1}"]
    if int(net["w0"].shape[0]) != OBSTACLE_FEATURES:
        raise ValueError(
            f"net input width {int(net['w0'].shape[0])} != "
            f"OBSTACLE_FEATURES = {OBSTACLE_FEATURES}")
    if int(w_last.shape[-1]) != 2:
        raise ValueError(
            f"net output width {int(w_last.shape[-1])} != 2 (accel, metric)")
    if metric_exploder_std_dev is None:
        metric_exploder_std_dev, metric_exploder_eps = 1e9, 1.0
    f32 = np.float32
    params = dict(net=net, support_radius=float(f32(support_radius)),
                  feat_sigma=float(f32(feat_sigma)),
                  vel_scale=float(f32(vel_scale)),
                  accel_scale=float(f32(accel_scale)),
                  metric_scale=float(f32(metric_scale)),
                  repulsion_boost=float(f32(repulsion_boost)),
                  repulsion_sigma=float(f32(repulsion_sigma)),
                  metric_exploder_std_dev=float(f32(metric_exploder_std_dev)),
                  metric_exploder_eps=float(f32(metric_exploder_eps)))
    return Policy(name, taskmap, _neural_obstacle_accel_metric, params)


def neural_attractor(goal, taskmap, net: dict, accel_scale: float = 4.0,
                     metric_scale: float = 1.0, metric_eps: float = 0.05,
                     feat_scale=None, name: str = "neural_target",
                     device=None) -> Policy:
    """Learned goal attractor on `taskmap` (task dim d from goal). net:
    mlp_init(gen, (2 d, *hidden, head_sizes(d))); its features are
    (goal - x, ẋ) / feat_scale (default ones)."""
    goal = torch.as_tensor(goal, dtype=torch.float32, device=device)
    d = goal.shape[-1]
    w_last = net[f"w{len(net) // 2 - 1}"]
    if int(w_last.shape[-1]) != head_sizes(d):
        raise ValueError(
            f"net output width {int(w_last.shape[-1])} != head_sizes({d}) "
            f"= {head_sizes(d)}")
    if int(net["w0"].shape[0]) != 2 * d:
        raise ValueError(
            f"net input width {int(net['w0'].shape[0])} != 2*d = {2 * d} "
            f"(features are concat(goal - x, xd))")
    if feat_scale is None:
        feat_scale = np.ones(2 * d, np.float32)
    f32 = np.float32
    params = dict(goal=goal, net=net,
                  accel_scale=float(f32(accel_scale)),
                  metric_scale=float(f32(metric_scale)),
                  metric_eps=float(f32(metric_eps)),
                  feat_scale=torch.as_tensor(np.asarray(feat_scale,
                                                        np.float32),
                                             device=device))
    return Policy(name, taskmap, _neural_attractor_accel_metric, params)
