"""Domain randomization of scenes, batched.

The port's `rmp_tpu/sim/randomizer.py`: cylindrical-coordinate obstacle
sampling, robot q/q̇ jitter around the ready pose and goal sampling with a
branchless rejection of goals inside obstacle clearance (the reference's
SceneRandomizer, simulation.py:494-548), plus the box-workspace samplers
and `SceneRandomizer`, the reference's stateful class surface over them.
Every sampler draws a whole batch from an explicit torch.Generator, or
from a RowStream: a generator over the rows of a larger batch, of which
this batch holds some (a rank's slice of a sharded batch, the G copies of
a sweep's fold). `uniform` and `normal` are the only draws. The
deterministic core of each (uniforms -> sample, candidates -> pick) is a
function of its own that takes the draws as arguments: jax.random streams
are not reproduced, so the tests feed these the JAX package's draws.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rmp_tpu_torch import default_device
from rmp_tpu_torch.models import robots
from rmp_tpu_torch.ops import geom
from rmp_tpu_torch.sim.collision import ObstacleSet, capsule_capsule_query


@dataclasses.dataclass(frozen=True)
class RowStream:
    """A random stream over `size` rows, of which a batch's env i holds row
    (offset + i) mod size. Every draw is made for all `size` rows, so the
    generator moves as it does for the whole batch, and each env keeps its
    own row: a rank's slice draws what the unsharded batch draws for its
    envs, and the G copies of a fold (offset 0, size the copies' batch)
    draw alike. JAX keys each env instead; the port keys each row."""

    gen: torch.Generator
    size: int
    offset: int = 0

    @property
    def device(self) -> torch.device:
        return self.gen.device


class Draws:
    """A stream that hands out given tensors in place of drawing them: what
    a traced tick draws from, so that an exported artifact takes each
    tick's draws as inputs (experiments/aot_export.py) and the caller
    draws them, in order, from its own generator. Without `given` it
    records each draw's (kind, shape, dtype) in `specs` and hands out
    zeros, for a trace that is thrown away; with `given` it hands those
    tensors out in order, each checked against the draw it stands for."""

    def __init__(self, device, given=None):
        self.device = torch.device(device)
        self.given = given
        self.specs: list[tuple[str, tuple, torch.dtype]] = []

    def take(self, fn, size: int, shape: tuple, dtype) -> torch.Tensor:
        kind = "normal" if fn is torch.randn else "uniform"
        spec = (kind, (size, *shape), dtype or torch.get_default_dtype())
        self.specs.append(spec)
        if self.given is None:
            return torch.zeros(spec[1], dtype=spec[2], device=self.device)
        if len(self.specs) > len(self.given):
            raise ValueError(f"draw {len(self.specs)} of a tick given "
                             f"{len(self.given)}")
        x = self.given[len(self.specs) - 1]
        if tuple(x.shape) != spec[1] or x.dtype != spec[2]:
            raise ValueError(f"draw {len(self.specs)} is {spec}, given "
                             f"{tuple(x.shape)} {x.dtype}")
        return x


def _raw(fn, gen, size: int, shape: tuple, dtype) -> torch.Tensor:
    if isinstance(gen, Draws):
        return gen.take(fn, size, shape, dtype)
    return fn(size, *shape, generator=gen, device=gen.device, dtype=dtype)


def _draw(fn, gen, batch: int, shape: tuple, dtype):
    if not isinstance(gen, RowStream):
        return _raw(fn, gen, batch, shape, dtype)
    u = _raw(fn, gen.gen, gen.size, shape, dtype)
    if gen.offset == 0 and gen.size == batch:
        return u
    rows = (torch.arange(batch, device=gen.device) + gen.offset) % gen.size
    return u.index_select(0, rows)


def uniform(gen, batch: int, *shape: int, dtype=None) -> torch.Tensor:
    """(batch, *shape) unit uniforms from a torch.Generator, a RowStream
    or Draws."""
    return _draw(torch.rand, gen, batch, shape, dtype)


def normal(gen, batch: int, *shape: int, dtype=None) -> torch.Tensor:
    """(batch, *shape) standard normals from a torch.Generator, a
    RowStream or Draws."""
    return _draw(torch.randn, gen, batch, shape, dtype)


@dataclasses.dataclass(frozen=True)
class CylinderSampleSpace:
    """Reference default_sample_space (simulation.py:495-500)."""

    position_cylindrical_low: tuple = (0.4, 0.0, 0.0)     # (r, phi, z)
    position_cylindrical_high: tuple = (0.9, 2 * np.pi, 1.0)
    orientation_low: tuple = (0.0, 0.0, 0.0)
    orientation_high: tuple = (np.pi, np.pi, np.pi)
    radius_low: float = 0.05
    radius_high: float = 0.1
    height_low: float = 0.5
    height_high: float = 0.5


@dataclasses.dataclass(frozen=True)
class RobotSampleSpace:
    """Reference default_robot_sample_space (simulation.py:502-506)."""

    q_low: np.ndarray = None
    q_high: np.ndarray = None
    qd_low: np.ndarray = None
    qd_high: np.ndarray = None

    @staticmethod
    def panda_default() -> "RobotSampleSpace":
        qr = robots.PANDA_Q_READY
        return RobotSampleSpace(q_low=qr - 0.1, q_high=qr + 0.1,
                                qd_low=np.full_like(qr, -0.005),
                                qd_high=np.full_like(qr, 0.005))


GOAL_CYL_LOW = np.asarray([0.4, 0.0, 0.0], dtype=np.float32)
GOAL_CYL_HIGH = np.asarray([0.9, 2 * np.pi, 1.0], dtype=np.float32)


_BOUNDS: dict[tuple, tuple] = {}


def scale_uniform(u: torch.Tensor, low, high) -> torch.Tensor:
    """Unit uniforms u in [0, 1) -> [low, high), in float32 as
    jax.random.uniform scales them: max(low, u (high - low) + low). The
    bounds become device tensors once per (bounds, device), so a tick
    copies nothing from the host."""
    lo32 = np.asarray(low, np.float32)
    hi32 = np.asarray(high, np.float32)
    key = (lo32.tobytes(), hi32.tobytes(), lo32.shape, str(u.device))
    bounds = _BOUNDS.get(key)
    if bounds is None:
        lo = torch.as_tensor(lo32, device=u.device)
        bounds = _BOUNDS[key] = (lo, torch.as_tensor(hi32,
                                                     device=u.device) - lo)
    lo, span = bounds
    return torch.maximum(lo, u * span + lo)


def _cylindrical_to_cartesian(rpz: torch.Tensor) -> torch.Tensor:
    r, phi, z = rpz[..., 0], rpz[..., 1], rpz[..., 2]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def obstacles_from_uniforms(u_pos: torch.Tensor, u_rpy: torch.Tensor,
                            u_radius: torch.Tensor, u_height: torch.Tensor,
                            space: CylinderSampleSpace | None = None
                            ) -> ObstacleSet:
    """Cylinders (as capsules) from unit uniforms: u_pos, u_rpy (..., n, 3)
    and u_radius, u_height (..., n) -> the segments of randomize_obstacles."""
    space = space or CylinderSampleSpace()
    center = _cylindrical_to_cartesian(scale_uniform(
        u_pos, space.position_cylindrical_low,
        space.position_cylindrical_high))
    rpy = scale_uniform(u_rpy, space.orientation_low, space.orientation_high)
    radius = scale_uniform(u_radius, space.radius_low, space.radius_high)
    height = scale_uniform(u_height, space.height_low, space.height_high)
    axis_dir = geom.rotation_matrix_from_rpy(rpy)[..., :, 2]
    half = (height / 2.0)[..., None] * axis_dir
    return ObstacleSet(p0=center - half, p1=center + half, radius=radius,
                       kinds=("cylinder",) * u_pos.shape[-2])


def randomize_obstacles(gen: torch.Generator, batch: int, n_obstacles: int,
                        space: CylinderSampleSpace | None = None
                        ) -> ObstacleSet:
    """n_obstacles cylinders per env, (batch, n, ...) leaves."""
    def u(*shape):
        return uniform(gen, batch, *shape)
    return obstacles_from_uniforms(u(n_obstacles, 3), u(n_obstacles, 3),
                                   u(n_obstacles), u(n_obstacles), space)


def randomize_robot_config(gen: torch.Generator, batch: int,
                           space: RobotSampleSpace | None = None):
    """(q, q̇) (batch, n) jittered around the ready pose."""
    space = space or RobotSampleSpace.panda_default()
    n = len(space.q_low)
    u_q = uniform(gen, batch, n)
    u_qd = uniform(gen, batch, n)
    return (scale_uniform(u_q, space.q_low, space.q_high),
            scale_uniform(u_qd, space.qd_low, space.qd_high))


def pick_clear_candidate(cand: torch.Tensor, obstacles: ObstacleSet,
                         clearance: float) -> torch.Tensor:
    """Branchless rejection core: per env, the first of the candidate
    points cand (B, tries, 3) with at least `clearance` of free space to the
    env's obstacles (B, K, ...), else the clearest one (first on a tie)."""
    _, _, _, d = capsule_capsule_query(
        cand[:, :, None], cand[:, :, None],
        torch.zeros(1, dtype=cand.dtype, device=cand.device),
        obstacles.p0[:, None], obstacles.p1[:, None],
        obstacles.radius[:, None])                        # (B, tries, K)
    clear = d.amin(dim=-1)                                # (B, tries)
    ok = clear >= clearance
    first = ok.to(torch.int8).argmax(dim=-1)              # first True
    pick = torch.where(ok.any(dim=-1), first, clear.argmax(dim=-1))
    return cand.gather(1, pick[:, None, None].expand(-1, 1, 3))[:, 0]


def randomize_goal(gen: torch.Generator, batch: int, low=GOAL_CYL_LOW,
                   high=GOAL_CYL_HIGH, obstacles: ObstacleSet | None = None,
                   clearance: float = 0.05, tries: int = 8) -> torch.Tensor:
    """(batch, 3) goals sampled in cylindrical coordinates (reference
    simulation.py:543-548). With `obstacles` (batch, K, ...), `tries`
    candidates per env at once, kept by pick_clear_candidate."""
    if obstacles is None or obstacles.count == 0:
        u = uniform(gen, batch, 3)
        return _cylindrical_to_cartesian(scale_uniform(u, low, high))
    u = uniform(gen, batch, tries, 3)
    cand = _cylindrical_to_cartesian(scale_uniform(u, low, high))
    return pick_clear_candidate(cand, obstacles, clearance)


def randomize_goal_box(gen: torch.Generator, batch: int, low, high,
                       obstacles: ObstacleSet | None = None,
                       clearance: float = 0.05, tries: int = 8
                       ) -> torch.Tensor:
    """(batch, 3) goals uniform in a Cartesian box, kept clear of
    `obstacles` as randomize_goal keeps them."""
    if obstacles is None or obstacles.count == 0:
        return scale_uniform(uniform(gen, batch, 3), low, high)
    cand = scale_uniform(uniform(gen, batch, tries, 3), low, high)
    return pick_clear_candidate(cand, obstacles, clearance)


def randomize_obstacles_box(gen: torch.Generator, batch: int,
                            n_obstacles: int, low, high,
                            radius_low: float = 0.04,
                            radius_high: float = 0.08, height: float = 0.5,
                            avoid=None, avoid_clearance: float = 0.03,
                            tries: int = 8) -> ObstacleSet:
    """Cylinders with centers uniform in a Cartesian box and orientation
    rpy uniform in [0, pi), (batch, n, ...) leaves. `avoid`: world capsules
    (p0 (B, P, 3), p1 (B, P, 3), radius (P,)) that the obstacles keep
    `avoid_clearance` from: each obstacle draws `tries` centers and keeps
    the first clear one, else the clearest."""
    shape = ((n_obstacles, 3) if avoid is None
             else (n_obstacles, tries, 3))
    center = scale_uniform(uniform(gen, batch, *shape), low, high)
    rpy = scale_uniform(uniform(gen, batch, n_obstacles, 3), 0.0, np.pi)
    radius = scale_uniform(uniform(gen, batch, n_obstacles), radius_low,
                           radius_high)
    axis_dir = geom.rotation_matrix_from_rpy(rpy)[..., :, 2]
    half = (height / 2.0) * axis_dir                      # (B, n, 3)
    if avoid is not None:
        ap0, ap1, ar = avoid
        c0 = center - half[:, :, None]                    # (B, n, tries, 3)
        c1 = center + half[:, :, None]
        _, _, _, d = capsule_capsule_query(
            c0[..., None, :], c1[..., None, :], radius[:, :, None, None],
            ap0[:, None, None], ap1[:, None, None], ar)   # (B, n, tries, P)
        clear = d.amin(dim=-1)
        ok = clear >= avoid_clearance
        first = ok.to(torch.int8).argmax(dim=-1)
        pick = torch.where(ok.any(dim=-1), first, clear.argmax(dim=-1))
        center = center.gather(
            2, pick[..., None, None].expand(-1, -1, 1, 3))[:, :, 0]
    return ObstacleSet(p0=center - half, p1=center + half, radius=radius,
                       kinds=("cylinder",) * n_obstacles)


class SceneRandomizer:
    """Object-style wrapper mirroring the reference class surface
    (randomize_obstacles / randomize_robot_config / randomize_goal): each
    call draws one scene's sample from the batched samplers above at batch
    1, from a torch.Generator seeded by `seed` on `device` (default: the
    card), and returns it without the batch axis."""

    def __init__(self, seed: int = 0,
                 sample_space: CylinderSampleSpace | None = None,
                 robot_space: RobotSampleSpace | None = None, device=None):
        self.gen = torch.Generator(
            device=default_device(device)).manual_seed(seed)
        self.sample_space = sample_space or CylinderSampleSpace()
        self.robot_space = robot_space or RobotSampleSpace.panda_default()

    def randomize_obstacles(self, n_obstacles: int) -> ObstacleSet:
        obs = randomize_obstacles(self.gen, 1, n_obstacles, self.sample_space)
        return ObstacleSet(p0=obs.p0[0], p1=obs.p1[0], radius=obs.radius[0],
                           kinds=obs.kinds)

    def randomize_robot_config(self):
        q, qd = randomize_robot_config(self.gen, 1, self.robot_space)
        return q[0], qd[0]

    def randomize_goal(self) -> torch.Tensor:
        return randomize_goal(self.gen, 1)[0]
