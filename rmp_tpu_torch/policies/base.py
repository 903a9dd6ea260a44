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
