"""Per-tick distance context for the collision policies, batched.

The port's `rmp_tpu/sim/data.py`. The context is a dict: frame_name ->
per-frame fields, plus the stacked (B, L, K, ...) fields of all collision
frames under PAIRS_KEY for grouped multi-frame policies. Fields:
pos_on_link, pos_on_obstacle, normal (B, [L,] K, 3), distance, mask
(B, [L,] K), and relative_position (B, [L,] K, 3) — the obstacle-nearest
body point in the joint frame.
"""
from __future__ import annotations

import torch

from rmp_tpu_torch.models.kinematics import frame_indices
from rmp_tpu_torch.models.urdf import KinematicModel
from rmp_tpu_torch.ops import geom
from rmp_tpu_torch.sim.collision import (
    ObstacleSet, robot_obstacle_distances, robot_obstacle_distances_hull,
    robot_obstacle_distances_hull_batched)

PAIRS_KEY = "__pairs__"
COLD_ITERS = 10     # GJK iterations of a query without a warm carry
WARM_ITERS = 4      # ... with one (the JAX package's RMP_GJK_ITERS default)


def distance_context(model: KinematicModel, T_all: torch.Tensor,
                     obstacles: ObstacleSet,
                     geometry: str = "capsule") -> dict[str, dict]:
    """Context of every collision frame for T_all (B, F, 4, 4).

    geometry 'capsule' (fitted multi-capsule links) or 'hull' with the JAX
    package's per-env semantics: every pair, cold, 10 GJK iterations."""
    if geometry == "hull":
        query = robot_obstacle_distances_hull(model, T_all, obstacles,
                                              iters=COLD_ITERS)
    elif geometry == "capsule":
        query = robot_obstacle_distances(model, T_all, obstacles)
    else:
        raise ValueError(f"unknown collision geometry {geometry!r}")
    return _ctx_build(model, T_all, query)


def hull_batched(geometry: str, batch: int) -> bool:
    """The JAX package's switch: True when a hull query of `batch` envs takes
    the batched semantics of its kernel path (broad phase, warm carry),
    False for the per-env semantics."""
    return geometry == "hull" and batch % 128 == 0


def distance_context_batched(model: KinematicModel, T_all: torch.Tensor,
                             obstacles: ObstacleSet,
                             geometry: str = "capsule",
                             warm: torch.Tensor | None = None,
                             iters: int | None = None):
    """(context, warm_next) of a whole batch, with the JAX package's switch
    for geometry 'hull': for B % 128 == 0 the batched semantics of its
    kernel path (top-3 broad phase, warm start from `warm` (B, L, K, 3);
    iters defaults to 10 cold and 4 warm) and a warm_next carry; otherwise
    the per-env semantics of distance_context and warm_next None. Other
    geometries return warm_next None."""
    if not hull_batched(geometry, T_all.shape[0]):
        return distance_context(model, T_all, obstacles, geometry), None
    if iters is None:
        iters = COLD_ITERS if warm is None else WARM_ITERS
    *query, warm_next = robot_obstacle_distances_hull_batched(
        model, T_all, obstacles, iters=iters, warm=warm)
    return _ctx_build(model, T_all, query), warm_next


def _ctx_build(model: KinematicModel, T_all: torch.Tensor, query):
    """Assemble the context from closest-point results (pos_on_link,
    pos_on_obstacle, normal, distance), shapes (B, L, K, ...)."""
    pos_on_link, pos_on_obstacle, normal, distance = query
    frames = model.collision_frames
    T = T_all.index_select(1, frame_indices(frames, T_all.device))
    R_joint_base = T[..., :3, :3].transpose(-1, -2)
    rel = geom.mv(R_joint_base[:, :, None],
                  pos_on_link - T[:, :, None, :3, 3])          # (B, L, K, 3)
    mask = torch.ones_like(distance)
    out = {PAIRS_KEY: dict(
        pos_on_link=pos_on_link, pos_on_obstacle=pos_on_obstacle,
        normal=normal, distance=distance, relative_position=rel, mask=mask)}
    for row, frame_idx in enumerate(frames):
        out[model.frame_names[frame_idx]] = dict(
            pos_on_link=pos_on_link[:, row],
            pos_on_obstacle=pos_on_obstacle[:, row],
            normal=normal[:, row],
            distance=distance[:, row],
            relative_position=rel[:, row],
            mask=mask[:, row],
        )
    return out
