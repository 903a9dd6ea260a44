"""Policy container: a named (taskmap, accel/metric) pair.

The port's `rmp_tpu/policies/base.py`. The leaf evaluation is a function of
(params, x, ẋ, ctx) on batched task coordinates x, ẋ (B, P, d), returning
a (B, P, d) and M (B, P, d, d)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass
class Policy:
    """A single RMP: taskmap fn(q, ctx) -> x (B, P, d) plus leaf evaluation
    accel_metric(params, x, xd, ctx) -> (a (B, P, d), M (B, P, d, d))."""

    name: str
    taskmap: Callable
    accel_metric: Callable
    params: Any = None
    # key into the per-tick context dict for policies that consume sensed
    # data; None otherwise
    ctx_key: str | None = None

    def with_params(self, **updates) -> "Policy":
        """A copy with some param entries replaced (a gain, a goal)."""
        return dataclasses.replace(self, params={**self.params, **updates})


def per_env(v):
    """A (B, d) per-env vector as (B, 1, d), broadcasting against the P task
    rows of x (B, P, d); a shared (d,) vector broadcasts as it is."""
    return v[:, None, :] if v.dim() == 2 else v


def per_env_scalar(v, ndim: int):
    """A per-env scalar param (B,) as (B, 1, ..., 1) of `ndim` axes, to
    broadcast against a leaf's (B, P, d) or (B, P, d, d) operands; a gain
    shared by the batch (a Python number, or a 0-d tensor such as a gain
    being tuned) as it is."""
    if isinstance(v, torch.Tensor) and v.dim() > 0:
        return v.reshape(v.shape[0], *(1,) * (ndim - 1))
    return v
