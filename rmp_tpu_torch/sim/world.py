"""Simulation world state, physics step and sensing, batched.

The port's functional core of `rmp_tpu/sim/world.py`: `physics_step` (the
commanded acceleration realised exactly, or through the torque path; no
contact yet) and `sense`. The imperative `Simulation` wrapper is not ported
yet."""
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
                 dt: float, torque_mode: bool = False,
                 enforce_velocity_limits: bool = False) -> SimState:
    """One physics step at dt.

    By default the commanded acceleration is realised exactly: the
    reference's inverse-dynamics torques followed by exact forward
    dynamics, which cancel in contact-free motion. torque_mode routes it
    through the torque level, τ = clip(ID(q, q̇, q̈), ±effort) and
    q̈ = FD(q, q̇, τ), where effort limits bite. enforce_velocity_limits
    clamps q̇ to the URDF velocity limits (dynamics.semi_implicit_euler_step)."""
    if torque_mode:
        effort = K.model_constants(model, qdd.device, qdd.dtype)[
            "effort_limit"]
        tau = dynamics.inverse_dynamics(model, state.q, state.qd, qdd)
        tau = torch.clamp(tau, -effort, effort)
        qdd = dynamics.forward_dynamics(model, state.q, state.qd, tau)
    q, qd = dynamics.semi_implicit_euler_step(
        model, state.q, state.qd, qdd, dt,
        enforce_velocity_limits=enforce_velocity_limits)
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
