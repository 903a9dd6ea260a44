"""Closest-point queries of the capsule tier, batched.

The port's capsule half of `rmp_tpu/sim/collision.py`: every link primitive
and every obstacle is a capsule (a sphere is a zero-length one), queried in
closed form. Each query returns what PyBullet's getClosestPoints does:
(point on link, point on obstacle, normal on the obstacle pointing toward the
link, signed distance). The exact convex-hull tier (GJK) is not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rmp_tpu_torch.models.urdf import KinematicModel, model_cache
from rmp_tpu_torch.ops import geom

_EPS = 1e-9


@dataclasses.dataclass
class ObstacleSet:
    """Struct-of-arrays obstacle collection, world frame.

    p0, p1: (..., K, 3) segment endpoints (equal for spheres); radius
    (..., K). kinds: optional static per-obstacle tags ('capsule' |
    'cylinder'); the capsule queries treat every shape as a capsule, the
    hull tier reads them. None means all-capsule."""

    p0: torch.Tensor
    p1: torch.Tensor
    radius: torch.Tensor
    kinds: tuple[str, ...] | None = None

    @property
    def count(self) -> int:
        return self.p0.shape[-2]

    @staticmethod
    def of(*obstacles: "ObstacleSet") -> "ObstacleSet":
        kinds = None
        if any(o.kinds is not None for o in obstacles):
            kinds = sum((o.kinds if o.kinds is not None
                         else ("capsule",) * o.count for o in obstacles), ())
        return ObstacleSet(
            p0=torch.cat([o.p0 for o in obstacles], dim=-2),
            p1=torch.cat([o.p1 for o in obstacles], dim=-2),
            radius=torch.cat([o.radius for o in obstacles], dim=-1),
            kinds=kinds)

    def expand(self, batch: int) -> "ObstacleSet":
        """The same (K, ...) set for each of `batch` environments (views)."""
        return ObstacleSet(self.p0.expand(batch, -1, -1),
                           self.p1.expand(batch, -1, -1),
                           self.radius.expand(batch, -1), self.kinds)


def cylinder_obstacle(base_position, base_orientation_euler, radius, height,
                      device=None) -> ObstacleSet:
    """Cylinder (axis = local z, centered) as a capsule p0/p1/radius plus
    its kind tag. base_orientation_euler: rpy, composed as in
    geom.rotation_matrix_from_rpy."""
    f32 = dict(dtype=torch.float32, device=device)
    c = torch.as_tensor(base_position, **f32)
    R = geom.rotation_matrix_from_rpy(
        torch.as_tensor(base_orientation_euler, **f32))
    half = (height / 2.0) * R[:, 2]
    return ObstacleSet((c - half)[None], (c + half)[None],
                       torch.as_tensor([radius], **f32), kinds=("cylinder",))


def segment_closest_params(a0, a1, b0, b1):
    """Clamped closest-point parameters (s, t) in [0, 1] between segments
    a0 + s (a1 - a0) and b0 + t (b1 - b0). Branchless two-pass clamp, safe
    for degenerate (point) segments; _EPS sits in every denominator."""
    d1 = a1 - a0
    d2 = b1 - b0
    r = a0 - b0
    a = torch.sum(d1 * d1, dim=-1)
    e = torch.sum(d2 * d2, dim=-1)
    f = torch.sum(d2 * r, dim=-1)
    c = torch.sum(d1 * r, dim=-1)
    b = torch.sum(d1 * d2, dim=-1)
    denom = a * e - b * b
    zero = torch.zeros_like(a)
    s = torch.where(denom > _EPS, (b * f - c * e) / (denom + _EPS), zero)
    # segment B degenerate (sphere): closest point on A to the point b0
    s = torch.where(e > _EPS, s, -c / (a + _EPS))
    s = torch.clamp(s, 0.0, 1.0)
    t = torch.where(e > _EPS, (b * s + f) / (e + _EPS), zero)
    t_cl = torch.clamp(t, 0.0, 1.0)
    # re-project s for clamped t
    s = torch.where((t != t_cl) & (a > _EPS),
                    torch.clamp((t_cl * b - c) / (a + _EPS), 0.0, 1.0), s)
    return s, t_cl


def capsule_capsule_query(a0, a1, ra, b0, b1, rb):
    """(pos_on_a, pos_on_b, normal_on_b, distance) between two capsules;
    the normal points from b toward a, the distance is negative on
    penetration. Broadcasts over leading axes."""
    s, t = segment_closest_params(a0, a1, b0, b1)
    ca = a0 + s[..., None] * (a1 - a0)
    cb = b0 + t[..., None] * (b1 - b0)
    diff = ca - cb
    center_dist = torch.linalg.vector_norm(diff, dim=-1)
    n = diff / (center_dist[..., None] + _EPS)
    pos_on_a = ca - ra[..., None] * n
    pos_on_b = cb + rb[..., None] * n
    distance = center_dist - ra - rb
    return pos_on_a, pos_on_b, n, distance


_PRIMS: dict[tuple, tuple] = {}


def _primitive_tables(model: KinematicModel, device, dtype):
    """(owner frames, p0 local, p1 local, radius, collision-frame rows) of
    every collision primitive, built once per (model, device, dtype)."""
    def build():
        p0, p1, radii, rows, owners = [], [], [], [], []
        for row, f in enumerate(model.collision_frames):
            for prim in model.collision[f]:
                p0.append(prim.p0)
                p1.append(prim.p1)
                radii.append(prim.radius)
                rows.append(row)
                owners.append(f)
        f = dict(dtype=dtype, device=device)
        return (torch.as_tensor(owners, dtype=torch.long, device=device),
                torch.as_tensor(np.asarray(p0, np.float32), **f),
                torch.as_tensor(np.asarray(p1, np.float32), **f),
                torch.as_tensor(radii, **f), tuple(rows))
    return model_cache(_PRIMS, model, (str(device), dtype), build)


def link_world_capsules_all(model: KinematicModel, T_all: torch.Tensor):
    """World-frame capsules of every collision primitive. T_all: (B, F, 4, 4)
    -> (p0 (B, P, 3), p1 (B, P, 3), radius (P,), frame_rows); frame_rows[i]
    is the collision-frame row (index into model.collision_frames) owning
    primitive i."""
    owners, p0_local, p1_local, radius, rows = _primitive_tables(
        model, T_all.device, T_all.dtype)
    T = T_all[:, owners]                                  # (B, P, 4, 4)
    return (geom.transform_point(T, p0_local),
            geom.transform_point(T, p1_local), radius, rows)


def robot_obstacle_distances(model: KinematicModel, T_all: torch.Tensor,
                             obstacles: ObstacleSet):
    """All link x obstacle closest-point queries for T_all (B, F, 4, 4) and
    obstacles (B, K, ...): (pos_on_link, pos_on_obstacle, normal) of shape
    (B, L, K, 3) and distance (B, L, K).

    A link of several primitives keeps, per obstacle, the CLOSEST
    primitive's result; on a tie the first primitive stays (strictly-less
    select, in primitive order)."""
    p0, p1, radius, rows = link_world_capsules_all(model, T_all)
    B, P, K = p0.shape[0], p0.shape[1], obstacles.count
    L = len(model.collision_frames)
    a0 = p0[:, :, None, :].expand(B, P, K, 3)
    a1 = p1[:, :, None, :].expand(B, P, K, 3)
    ra = radius[None, :, None].expand(B, P, K)
    b0 = obstacles.p0[:, None].expand(B, P, K, 3)
    b1 = obstacles.p1[:, None].expand(B, P, K, 3)
    rb = obstacles.radius[:, None].expand(B, P, K)
    pos_l, pos_o, n, d = capsule_capsule_query(a0, a1, ra, b0, b1, rb)
    if P == L:                       # one primitive per frame: no reduction
        return pos_l, pos_o, n, d
    out_pl, out_po, out_n, out_d = [], [], [], []
    for row in range(L):
        idx = [i for i, r in enumerate(rows) if r == row]
        i0 = idx[0]
        bpl, bpo, bn, bd = pos_l[:, i0], pos_o[:, i0], n[:, i0], d[:, i0]
        for i in idx[1:]:
            closer = d[:, i] < bd                        # (B, K)
            c3 = closer[..., None]
            bpl = torch.where(c3, pos_l[:, i], bpl)
            bpo = torch.where(c3, pos_o[:, i], bpo)
            bn = torch.where(c3, n[:, i], bn)
            bd = torch.where(closer, d[:, i], bd)
        out_pl.append(bpl)
        out_po.append(bpo)
        out_n.append(bn)
        out_d.append(bd)
    return (torch.stack(out_pl, dim=1), torch.stack(out_po, dim=1),
            torch.stack(out_n, dim=1), torch.stack(out_d, dim=1))
