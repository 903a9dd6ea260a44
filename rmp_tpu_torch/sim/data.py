"""Per-tick distance context for the collision policies, batched.

The port's `rmp_tpu/sim/data.py` (capsule tier). The context is a dict:
frame_name -> per-frame fields, plus the stacked (B, L, K, ...) fields of
all collision frames under PAIRS_KEY for grouped multi-frame policies.
Fields: pos_on_link, pos_on_obstacle, normal (B, [L,] K, 3), distance,
mask (B, [L,] K), and relative_position (B, [L,] K, 3) — the
obstacle-nearest body point in the joint frame.
"""
from __future__ import annotations

import torch

from rmp_tpu_torch.models.kinematics import frame_indices
from rmp_tpu_torch.models.urdf import KinematicModel
from rmp_tpu_torch.ops import geom
from rmp_tpu_torch.sim.collision import ObstacleSet, robot_obstacle_distances

PAIRS_KEY = "__pairs__"


def distance_context(model: KinematicModel, T_all: torch.Tensor,
                     obstacles: ObstacleSet) -> dict[str, dict]:
    """Context of every collision frame for T_all (B, F, 4, 4)."""
    return _ctx_build(model, T_all,
                      robot_obstacle_distances(model, T_all, obstacles))


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
