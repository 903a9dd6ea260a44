"""Simulation world state, physics step and sensing, batched.

The port's `rmp_tpu/sim/world.py`: the functional core, `physics_step` (the
commanded acceleration realised exactly, or through the torque path, with
penalty or impulse contacts on request) and `sense`, and the imperative
`Simulation` wrapper with the reference's surface (connect /
populate_scene / state / step / reset), a batch of one on the card unless
the caller asks for the CPU, which captures an animation on request
(utils/render.py, utils/native.py)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rmp_tpu_torch import default_device
from rmp_tpu_torch.models import kinematics as K
from rmp_tpu_torch.models.urdf import KinematicModel
from rmp_tpu_torch.sim import dynamics
from rmp_tpu_torch.sim.collision import ObstacleSet
from rmp_tpu_torch.sim.data import distance_context
from rmp_tpu_torch.sim.objects import Goal, Robot, SceneObject


@dataclasses.dataclass
class SimState:
    """World state: q, qd (B, n), t (B,), obstacles (B, K, ...) and the goal
    position (B, 3), or None."""

    q: torch.Tensor
    qd: torch.Tensor
    t: torch.Tensor
    obstacles: ObstacleSet | None = None
    goal: torch.Tensor | None = None


def _batched(x: torch.Tensor, batch: int) -> torch.Tensor:
    return x.expand(batch, *x.shape).clone()


def init_state(model: KinematicModel, batch: int, device, q=None,
               obstacles: ObstacleSet | None = None, goal=None) -> SimState:
    """`batch` identical states at rest at q (default zeros); obstacles
    (K, ...) and goal (3,) (or one goal per arm, (A, 3)) are shared by
    every environment."""
    f32 = dict(dtype=torch.float32, device=device)
    n = model.n_q
    q0 = torch.zeros(n, **f32) if q is None else torch.as_tensor(q, **f32)
    return SimState(
        q=q0.expand(batch, n).clone(),
        qd=torch.zeros(batch, n, **f32),
        t=torch.zeros(batch, **f32),
        obstacles=None if obstacles is None else obstacles.expand(batch),
        goal=None if goal is None
        else _batched(torch.as_tensor(goal, **f32), batch),
    )


def physics_step(model: KinematicModel, state: SimState, qdd: torch.Tensor,
                 dt: float, torque_mode: bool = False,
                 enforce_limits: bool = True,
                 enforce_velocity_limits: bool = False,
                 contact: bool = False, contact_params=None,
                 contact_model: str = "penalty") -> SimState:
    """One physics step at dt.

    By default the commanded acceleration is realised exactly: the
    reference's inverse-dynamics torques followed by exact forward
    dynamics, which cancel in contact-free motion. torque_mode (and
    contact) route it through the torque level, τ = clip(ID(q, q̇, q̈),
    ±effort) and q̈ = FD(q, q̇, τ), where effort limits bite.
    enforce_limits clamps q to the joint limits and zeroes the outward q̇
    there; enforce_velocity_limits clamps q̇ to the URDF velocity limits
    (dynamics.semi_implicit_euler_step).

    contact: with contact_model 'penalty' the penalty torques of
    sim/contact.contact_torques (contact_params, default ContactParams())
    join τ; with 'impulse' the integrated q̇ is resolved by
    contact.impulse_contact_velocity, q re-integrated from the step's
    start as q + q̇ dt and, with enforce_limits, clamped again."""
    if torque_mode or contact:
        effort = K.model_constants(model, qdd.device, qdd.dtype)[
            "effort_limit"]
        tau = dynamics.inverse_dynamics(model, state.q, state.qd, qdd)
        tau = torch.clamp(tau, -effort, effort)
        if contact and contact_model == "penalty":
            from rmp_tpu_torch.sim.contact import (ContactParams,
                                                   contact_torques)
            tau = tau + contact_torques(model, state.q, state.qd,
                                        state.obstacles,
                                        contact_params or ContactParams())
        qdd = dynamics.forward_dynamics(model, state.q, state.qd, tau)
    q, qd = dynamics.semi_implicit_euler_step(
        model, state.q, state.qd, qdd, dt, enforce_limits,
        enforce_velocity_limits)
    if contact and contact_model == "impulse":
        from rmp_tpu_torch.sim.contact import impulse_contact_velocity
        qd = impulse_contact_velocity(model, state.q, qd, dt,
                                      obstacles=state.obstacles)
        q = state.q + qd * dt
        if enforce_limits:
            c = K.model_constants(model, q.device, q.dtype)
            low, high = c["q_lower"], c["q_upper"]
            below, above = q < low, q > high
            q = torch.clamp(q, low, high)
            zero = torch.zeros_like(qd)
            qd = torch.where(below & (qd < 0), zero, qd)
            qd = torch.where(above & (qd > 0), zero, qd)
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


def scene_to_obstacles(objects: list[SceneObject],
                       device=None) -> ObstacleSet | None:
    """The obstacle set of the objects that have a collision shape, or None
    when none has."""
    sets = [o.as_obstacle(device=device) for o in objects]
    sets = [s for s in sets if s is not None]
    return ObstacleSet.of(*sets) if sets else None


class Simulation:
    """Imperative wrapper with the reference Simulation surface, over a
    batch of one on `device` (default: the GPU; raises without one).
    connect() and disconnect() stay for familiarity: there is no physics
    server. With animation_save_path, step() captures a frame every 1/16 s
    of simulated time (the native ray tracer, utils/native.py, where a C++
    compiler is there, else matplotlib, as the JAX package chooses), and
    save_animation() writes them as a GIF."""

    def __init__(self, delta_t: float = 0.01, animation_save_path=None,
                 torque_mode: bool = False, device=None):
        self.device = default_device(device)
        self._delta_t = delta_t
        self.t = 0.0
        self.robot: Robot | None = None
        self.goal: Goal | None = None
        self.obstacles: list[SceneObject] = []
        self.animation_save_path = animation_save_path
        self._frames: list = []
        self._fps_animation = 16
        self._t_prev_animation = 0.0
        self.renderer: str | None = None   # the one the capture took
        self._torque_mode = torque_mode
        self._state: SimState | None = None
        self._model: KinematicModel | None = None

    def connect(self):
        return self

    def disconnect(self):
        self.clear_scene()

    @property
    def delta_t(self) -> float:
        return self._delta_t

    @property
    def n_obstacles(self) -> int:
        return len(self.obstacles)

    def populate_scene(self, objects):
        if not isinstance(objects, list):
            objects = [objects]
        for obj in objects:
            if isinstance(obj, Robot):
                self.robot = obj
                self._model = obj.model
            elif isinstance(obj, Goal):
                self.goal = obj
            else:
                self.obstacles.append(obj)
        self._rebuild_state()

    def clear_scene(self):
        self.obstacles = []
        self.robot = None
        self.goal = None
        self._state = None

    def reset(self):
        self.t = 0.0
        self._rebuild_state()

    def _rebuild_state(self):
        if self.robot is None:
            return
        state = init_state(
            self._model, 1, self.device, q=self.robot.q,
            obstacles=scene_to_obstacles(self.obstacles, self.device),
            goal=None if self.goal is None else self.goal.base_position)
        self._state = dataclasses.replace(state, qd=self._row(self.robot.qd))

    def _row(self, value) -> torch.Tensor:
        return torch.as_tensor(np.asarray(value, np.float32),
                               device=self.device).reshape(1, -1)

    @property
    def q(self) -> np.ndarray:
        return self._state.q[0].cpu().numpy()

    @q.setter
    def q(self, value):
        self._state = dataclasses.replace(self._state, q=self._row(value))

    @property
    def qd(self) -> np.ndarray:
        return self._state.qd[0].cpu().numpy()

    @qd.setter
    def qd(self, value):
        self._state = dataclasses.replace(self._state, qd=self._row(value))

    def state(self):
        """(q, q̇, distance context): q and q̇ as numpy vectors, the context
        unbatched (per frame: fields (K, ...) on the device), the layout
        RmpCore.evaluate takes."""
        q, qd, ctx = sense(self._model, self._state)
        ctx = {key: {name: v[0] for name, v in fields.items()}
               for key, fields in ctx.items()}
        return q[0].cpu().numpy(), qd[0].cpu().numpy(), ctx

    def step(self, qdd_desired):
        """Advance one physics step of delta_t with the commanded q̈."""
        qdd = torch.as_tensor(qdd_desired, dtype=torch.float32,
                              device=self.device).reshape(1, -1)
        self._state = physics_step(self._model, self._state, qdd,
                                   self._delta_t,
                                   torque_mode=self._torque_mode)
        self.t += self._delta_t
        if (self.animation_save_path is not None and self.t
                > self._t_prev_animation + 1.0 / self._fps_animation):
            self._capture_frame()
            self._t_prev_animation = self.t

    def _capture_frame(self):
        from rmp_tpu_torch.utils.render import render_frame
        frame, self.renderer = render_frame(self._model, self._state,
                                            goal=self.goal,
                                            objects=self.obstacles)
        self._frames.append(frame)

    def save_animation(self):
        """Write the captured frames to animation_save_path as a GIF."""
        if self.animation_save_path and self._frames:
            from rmp_tpu_torch.utils.render import save_gif
            save_gif(self._frames, self.animation_save_path,
                     fps=self._fps_animation)
