"""Simulation world state, physics step and sensing, batched.

The port's functional core of `rmp_tpu/sim/world.py`: `physics_step` on its
default branch (the commanded acceleration is realised exactly; no torque
path, no contact) and `sense`. The imperative `Simulation` wrapper is not
ported yet."""
from __future__ import annotations

import dataclasses

import torch

from rmp_tpu_torch.models import kinematics as K
from rmp_tpu_torch.models.urdf import KinematicModel
from rmp_tpu_torch.sim import dynamics
from rmp_tpu_torch.sim.collision import ObstacleSet
from rmp_tpu_torch.sim.data import distance_context


@dataclasses.dataclass
class SimState:
    """World state: q, qd (B, n), t (B,), obstacles (B, K, ...) and the goal
    position (B, 3), or None."""

    q: torch.Tensor
    qd: torch.Tensor
    t: torch.Tensor
    obstacles: ObstacleSet | None = None
    goal: torch.Tensor | None = None


def init_state(model: KinematicModel, batch: int, device, q=None,
               obstacles: ObstacleSet | None = None, goal=None) -> SimState:
    """`batch` identical states at rest at q (default zeros); obstacles
    (K, ...) and goal (3,) are shared by every environment."""
    f32 = dict(dtype=torch.float32, device=device)
    n = model.n_q
    q0 = torch.zeros(n, **f32) if q is None else torch.as_tensor(q, **f32)
    return SimState(
        q=q0.expand(batch, n).clone(),
        qd=torch.zeros(batch, n, **f32),
        t=torch.zeros(batch, **f32),
        obstacles=None if obstacles is None else obstacles.expand(batch),
        goal=None if goal is None
        else torch.as_tensor(goal, **f32).expand(batch, 3).clone(),
    )


def physics_step(model: KinematicModel, state: SimState, qdd: torch.Tensor,
                 dt: float) -> SimState:
    """One physics step at dt with the commanded acceleration realised
    exactly — the reference's inverse-dynamics torques followed by exact
    forward dynamics, which cancel in contact-free motion."""
    q, qd = dynamics.semi_implicit_euler_step(model, state.q, state.qd, qdd,
                                              dt)
    return dataclasses.replace(state, q=q, qd=qd, t=state.t + dt)


def sense(model: KinematicModel, state: SimState,
          T_all: torch.Tensor | None = None, geometry: str = "capsule"):
    """(q, q̇, distance context). T_all: the tick's world transforms
    (B, F, 4, 4) at state.q when the caller already has them. geometry:
    'capsule' or 'hull' (exact mesh hulls, per-env semantics)."""
    ctx = {}
    if state.obstacles is not None and state.obstacles.count > 0:
        if T_all is None:
            T_all = K.fk_all(model, state.q)
        ctx = distance_context(model, T_all, state.obstacles, geometry)
    return state.q, state.qd, ctx
