"""Policy container: a named (taskmap, accel/metric) pair.

The port's `rmp_tpu/policies/base.py`. The leaf evaluation is a function of
(params, x, ẋ, ctx) on batched task coordinates x, ẋ (B, P, d), returning
a (B, P, d) and M (B, P, d, d)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable


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
