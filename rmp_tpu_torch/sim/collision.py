"""Closest-point queries of the capsule and exact-hull tiers, batched.

The port's `rmp_tpu/sim/collision.py` for robot-vs-obstacle queries. In the
capsule tier every link primitive and every obstacle is a capsule (a sphere
is a zero-length one), queried in closed form. In the hull tier each link is
the convex hull of its mesh (models/hulls.py), queried against capsules and
flat-capped cylinders by the K4 GJK kernel. Each query returns what
PyBullet's getClosestPoints does: (point on link, point on obstacle, normal
on the obstacle pointing toward the link, signed distance). Self-distances
between the robot's own links (`self_collision_pairs`) are queried in the
capsule tier (`robot_self_distances`) and hull against hull
(`robot_self_distances_hull`, by the plain PyTorch GJK of ops/gjk.py, as
the JAX package runs it in XLA).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rmp_tpu_torch.models.hulls import hull_table
from rmp_tpu_torch.models.kinematics import frame_indices
from rmp_tpu_torch.models.urdf import KinematicModel, model_cache
from rmp_tpu_torch.ops import geom, gjk
from rmp_tpu_torch.ops.cuda_gjk import gjk_hull_obstacles

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


def pad_obstacles(obstacles: ObstacleSet, capacity: int,
                  far: float = 50.0) -> ObstacleSet:
    """The set padded to `capacity` obstacles with inert ones far away: each
    pad is the segment (far, far, far) -> (far, far, far + 0.1) of radius
    0.01, where every obstacle policy's metric is exactly zero and the
    broad phase never picks it while a real obstacle is nearer. The pads
    take the set's own kind where the set is uniform, else 'capsule'.
    Works on (K, ...) and batched (B, K, ...) leaves."""
    K = obstacles.count
    if capacity < K:
        raise ValueError(f"capacity {capacity} < obstacle count {K}")
    if capacity == K:
        return obstacles
    pad = capacity - K
    f32 = dict(dtype=obstacles.p0.dtype, device=obstacles.p0.device)
    lead = obstacles.p0.shape[:-2]
    p0 = torch.tensor([far, far, far], **f32).expand(*lead, pad, 3)
    p1 = torch.tensor([far, far, far + 0.1], **f32).expand(*lead, pad, 3)
    kinds = obstacles.kinds
    if kinds is not None:
        kinds = kinds + ((kinds[0] if len(set(kinds)) == 1 else "capsule"),
                         ) * pad
    return ObstacleSet(
        p0=torch.cat([obstacles.p0, p0], dim=-2),
        p1=torch.cat([obstacles.p1, p1], dim=-2),
        radius=torch.cat([obstacles.radius,
                          torch.full((*lead, pad), 0.01, **f32)], dim=-1),
        kinds=kinds)


def sphere_obstacle(center, radius, device=None) -> ObstacleSet:
    """A sphere: a capsule of zero length."""
    c = torch.as_tensor(center, dtype=torch.float32, device=device)[None]
    return ObstacleSet(c, c, torch.as_tensor([radius], dtype=torch.float32,
                                             device=device))


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


def link_world_capsules(model: KinematicModel, T_all: torch.Tensor):
    """World-frame (p0, p1, radius) of the FIRST collision primitive of each
    collision frame: T_all (B, F, 4, 4) -> (B, L, 3), (B, L, 3), (L,)."""
    p0, p1, radius, rows = link_world_capsules_all(model, T_all)
    first = [rows.index(r) for r in range(len(model.collision_frames))]
    return p0[:, first], p1[:, first], radius[first]


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


HULL_CONTACT = 5e-4    # hull clearance at or below which the capsule answers
_FLAGS: dict[tuple, torch.Tensor] = {}


def _cylinder_flags(kinds: tuple[str, ...], device) -> torch.Tensor:
    """(K,) float32 1.0 for 'cylinder' kinds, built once per (kinds, device)
    so a tick copies nothing from the host."""
    key = (kinds, str(device))
    flags = _FLAGS.get(key)
    if flags is None:
        flags = _FLAGS[key] = torch.tensor(
            [float(k == "cylinder") for k in kinds], dtype=torch.float32,
            device=device)
    return flags


def broad_phase(cap_d: torch.Tensor, top_m: int) -> torch.Tensor:
    """(B, L, top_m) obstacle indices of the top_m nearest obstacles per
    (env, link) by capsule distance cap_d (B, L, K), nearest first; equal
    distances keep the lower obstacle index first, as the JAX package's
    where-chain does (a stable sort; torch.topk promises no order)."""
    return torch.sort(cap_d, dim=-1, stable=True).indices[..., :top_m]


def gjk_operands(model: KinematicModel, T_all: torch.Tensor,
                 obstacles: ObstacleSet, capsule_query, top_m: int = 3,
                 warm: torch.Tensor | None = None,
                 hull_verts: torch.Tensor | None = None):
    """(idx, operands) of the K4 call of the batched hull query: idx (B, L, M)
    the broad phase's obstacle indices (None when every pair runs) and the
    kernel's batch-minor operands by name (gjk_hull_obstacles' arguments).
    capsule_query: robot_obstacle_distances at the same poses; hull_verts
    (L, V, 3) in link coordinates, the robot's hull table if None."""
    cap_pl, cap_po, _, cap_d = capsule_query
    device = T_all.device
    T = T_all.index_select(1, frame_indices(model.collision_frames, device))
    R, t = T[..., :3, :3], T[..., :3, 3]                  # (B, L, 3, 3), (B, L, 3)
    local = (hull_table(model, device) if hull_verts is None else
             torch.as_tensor(hull_verts, dtype=torch.float32,
                             device=device).contiguous())  # (L, V, 3)
    B, L, K = cap_d.shape

    p0, p1, rb = obstacles.p0, obstacles.p1, obstacles.radius
    axis = p1 - p0
    an = axis / (torch.linalg.vector_norm(axis, dim=-1, keepdim=True) + 1e-12)
    is_cyl = _cylinder_flags(obstacles.kinds or ("capsule",) * K, device)

    centroid = geom.mv(R, local.mean(dim=-2)) + t         # (B, L, 3)
    d0_centroid = ((p0 + p1) / 2)[:, None] - centroid[:, :, None]
    d0_cap = cap_po - cap_pl
    degenerate = torch.sum(d0_cap * d0_cap, dim=-1, keepdim=True) < 1e-8
    d0 = torch.where(degenerate, d0_centroid, d0_cap)     # (B, L, K, 3)
    if warm is not None:
        live = torch.sum(warm * warm, dim=-1, keepdim=True) > 1e-10
        d0 = torch.where(live, warm, d0)

    M = min(top_m, K)
    per_obstacle = torch.cat([p0, p1, an, rb[..., None],
                              is_cyl.expand(B, K)[..., None]], dim=-1)
    idx = None
    if M < K:
        idx = broad_phase(cap_d, M)                       # (B, L, M)
        pick = per_obstacle[:, None].expand(B, L, K, 11).gather(
            2, idx[..., None].expand(B, L, M, 11))
        d0 = d0.gather(2, idx[..., None].expand(B, L, M, 3))
    else:
        pick = per_obstacle[:, None].expand(B, L, K, 11)
    # (B, L, M, C) -> (L, M, C, B): the kernel's batch-minor operands
    ops = torch.cat([pick, d0], dim=-1).permute(1, 2, 3, 0)
    names = ("p0", "p1", "an", "radius", "is_cyl", "d0")
    cuts = ((0, 3), (3, 6), (6, 9), (9, 10), (10, 11), (11, 14))
    operands = dict(verts=local, R=R.permute(1, 2, 3, 0).contiguous(),
                    t=t.permute(1, 2, 0).contiguous())
    operands.update((name, ops[:, :, a:b].contiguous())
                    for name, (a, b) in zip(names, cuts))
    return idx, operands


def robot_obstacle_distances_hull_batched(model: KinematicModel,
                                          T_all: torch.Tensor,
                                          obstacles: ObstacleSet,
                                          iters: int = 10, top_m: int = 3,
                                          warm: torch.Tensor | None = None,
                                          hull_verts: torch.Tensor | None = None
                                          ):
    """Exact-hull closest points of every (env, link, obstacle) pair through
    the K4 kernel: T_all (B, F, 4, 4), obstacles (B, K, ...) ->
    (pos_on_link, pos_on_obstacle, normal) (B, L, K, 3), distance (B, L, K)
    and warm_next (B, L, K, 3), after rmp_tpu's function of the same name.

    - Start direction per pair: the capsule witness difference, the
      centroid difference where that is degenerate (|d|^2 < 1e-8), and the
      previous tick's warm carry where |warm|^2 > 1e-10.
    - Broad phase: only the top_m obstacles nearest by capsule distance per
      (env, link) run GJK; every other pair keeps its capsule result.
      top_m >= K runs every pair.
    - Near contact (hull clearance <= 0.5 mm) the capsule result answers,
      with distance min(capsule, hull).
    - warm_next = pos_on_obstacle - pos_on_link, the next tick's carry.
    - hull_verts (L, V, 3): the link hulls in link coordinates, in place of
      the robot's hull table.
    """
    cap = robot_obstacle_distances(model, T_all, obstacles)
    cap_pl, cap_po, cap_n, cap_d = cap
    idx, operands = gjk_operands(model, T_all, obstacles, cap, top_m, warm,
                                 hull_verts)
    pa_k, pb_k, dist_k = gjk_hull_obstacles(**operands, iters=iters)
    pa = pa_k.permute(3, 0, 1, 2)                         # (B, L, M, 3)
    pb = pb_k.permute(3, 0, 1, 2)
    dist = dist_k.permute(2, 0, 1)                        # (B, L, M)

    if idx is not None:
        # scatter the M exact results back; the other pairs keep the capsule
        sel = torch.zeros_like(cap_d, dtype=torch.bool).scatter(2, idx, True)
        idx3 = idx[..., None].expand(*idx.shape, 3)
        dist = cap_d.scatter(2, idx, dist)
        pa = cap_pl.scatter(2, idx3, pa)
        pb = cap_po.scatter(2, idx3, pb)
        n = torch.where(sel[..., None], (pa - pb) / (dist[..., None] + 1e-9),
                        cap_n)
        near = sel & (dist <= HULL_CONTACT)
    else:
        n = (pa - pb) / (dist[..., None] + 1e-9)
        near = dist <= HULL_CONTACT
    n3 = near[..., None]
    out_pa = torch.where(n3, cap_pl, pa)
    out_pb = torch.where(n3, cap_po, pb)
    return (out_pa, out_pb, torch.where(n3, cap_n, n),
            torch.where(near, torch.minimum(cap_d, dist), dist),
            out_pb - out_pa)


def robot_obstacle_distances_hull(model: KinematicModel,
                                  T_all: torch.Tensor,
                                  obstacles: ObstacleSet,
                                  hull_verts: torch.Tensor | None = None,
                                  iters: int = 10):
    """Exact-hull closest points with the JAX package's per-env contract
    (rmp_tpu's function of the same name), batched: T_all (B, F, 4, 4),
    obstacles (B, K, ...) -> (pos_on_link, pos_on_obstacle, normal)
    (B, L, K, 3) and distance (B, L, K). Every (link, obstacle) pair runs
    `iters` cold GJK iterations through K4, started from the capsule
    witness direction (the centroid difference where it is degenerate);
    at a hull clearance of 0.5 mm or less the capsule result answers, with
    distance min(capsule, hull). hull_verts (L, V, 3) stands in for the
    robot's hull table; without either it raises."""
    return robot_obstacle_distances_hull_batched(
        model, T_all, obstacles, iters=iters, top_m=obstacles.count,
        hull_verts=hull_verts)[:4]


def self_collision_pairs(model: KinematicModel, n_neighbors: int = 3,
                         exclude_below: float | None = None, q_ref=None):
    """Static (frame_a, frame_b) pairs of collision frames at least
    n_neighbors apart in the kinematic tree (either frame among the other's
    last n_neighbors + 1 ancestors excludes the pair; siblings such as the
    two fingers stay). exclude_below (with q_ref, default zeros): also drop
    the pairs whose capsule distance at q_ref is below it, geometry that
    sits close by construction (fingers, hand against wrist). Runs on the
    host once, at scene construction."""
    frames = model.collision_frames
    pairs = []
    for a in frames:
        for b in frames:
            if a == b:
                continue
            chain_a, chain_b = model.chain(a), model.chain(b)
            if (a in chain_b[-n_neighbors - 1:]
                    or b in chain_a[-n_neighbors - 1:]):
                continue
            if (b, a) in pairs:
                continue
            pairs.append((a, b))
    if exclude_below is not None:
        from rmp_tpu_torch.models.kinematics import fk_all
        q = (torch.zeros(model.n_q) if q_ref is None
             else torch.as_tensor(np.asarray(q_ref, np.float32)))
        _, _, _, d = robot_self_distances(model, fk_all(model, q[None]),
                                          tuple(pairs))
        pairs = [p for p, dd in zip(pairs, d[0].tolist())
                 if dd >= exclude_below]
    return tuple(pairs)


_SELF: dict[tuple, tuple] = {}


def _self_pair_tables(model: KinematicModel, pairs, device):
    """(IA, IB) (P, C) long tensors of primitive indices: row k lists the
    primitive cross product of pair k, padded to the longest product by
    repeating its last combination (harmless under the min). Built once per
    (model, pairs, device) on the host."""
    def build():
        rows = _primitive_tables(model, torch.device("cpu"),
                                 torch.float32)[4]
        pos = {f: i for i, f in enumerate(model.collision_frames)}
        groups: dict[int, list[int]] = {}
        for i, r in enumerate(rows):
            groups.setdefault(r, []).append(i)
        combos = [[(i, j) for i in groups[pos[a]] for j in groups[pos[b]]]
                  for a, b in pairs]
        C = max(len(cs) for cs in combos)
        IA = np.zeros((len(pairs), C), np.int64)
        IB = np.zeros((len(pairs), C), np.int64)
        for k, cs in enumerate(combos):
            for c in range(C):
                IA[k, c], IB[k, c] = cs[min(c, len(cs) - 1)]
        return (torch.as_tensor(IA, device=device),
                torch.as_tensor(IB, device=device))
    return model_cache(_SELF, model, (tuple(pairs), str(device)), build)


def robot_self_distances(model: KinematicModel, T_all: torch.Tensor,
                         pairs: tuple[tuple[int, int], ...]):
    """Closest points between the capsule sets of static frame pairs, the
    min over each pair's primitive cross product (the first on a tie):
    T_all (B, F, 4, 4) -> (pos_on_a, pos_on_b, normal) (B, P, 3) and
    distance (B, P), P = len(pairs), in robot_obstacle_distances' layout
    with frame a as the link and frame b as the obstacle."""
    p0, p1, radius, _ = link_world_capsules_all(model, T_all)
    IA, IB = _self_pair_tables(model, pairs, T_all.device)
    pl, po, n, d = capsule_capsule_query(p0[:, IA], p1[:, IA], radius[IA],
                                         p0[:, IB], p1[:, IB], radius[IB])
    k = d.argmin(dim=-1, keepdim=True)           # (B, P, 1), first on a tie
    k3 = k[..., None].expand(*k.shape, 3)
    return (pl.gather(2, k3)[:, :, 0], po.gather(2, k3)[:, :, 0],
            n.gather(2, k3)[:, :, 0], d.gather(2, k)[:, :, 0])


_SELF_HULL: dict[tuple, tuple] = {}


def _self_hull_tables(model: KinematicModel, pairs, device):
    """(frames a, frames b) (P,) long tensors and the local hull tables
    (P, V, 3) of each pair's two links, built once per (model, pairs,
    device)."""
    def build():
        table = hull_table(model, device)
        row = {f: i for i, f in enumerate(model.collision_frames)}

        def idx(fs):
            return torch.as_tensor(fs, dtype=torch.long, device=device)
        fa, fb = [a for a, _ in pairs], [b for _, b in pairs]
        return (idx(fa), idx(fb), table[idx([row[f] for f in fa])],
                table[idx([row[f] for f in fb])])
    return model_cache(_SELF_HULL, model, (tuple(pairs), str(device)), build)


def _posed_support(local: torch.Tensor, T: torch.Tensor):
    """Support of the hulls `local` (P, V, 3) posed by T (B, P, 4, 4):
    the local support in R^T d, moved to the world."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = R.transpose(-1, -2)

    def support(d):
        return geom.mv(R, gjk.support_hull(local, geom.mv(Rt, d))) + t
    return support


def robot_self_distances_hull(model: KinematicModel, T_all: torch.Tensor,
                              pairs: tuple[tuple[int, int], ...],
                              iters: int = 10):
    """Hull-vs-hull closest points of static frame pairs, the exact-hull
    form of robot_self_distances (its return layout, (B, P, ...)): simplex
    GJK (ops/gjk.closest_points, `iters` iterations, cold) on both links'
    hulls, each support taken in its link's frame. The start direction is
    the capsule query's witness direction, or the hull centres' where that
    is degenerate. Near contact (distance <= 0.5 mm, or overlap) the
    capsule result stands in: its depth and normal, and min(capsule, hull)
    distance."""
    cap_pl, cap_po, cap_n, cap_d = robot_self_distances(model, T_all, pairs)
    fa, fb, la, lb = _self_hull_tables(model, pairs, T_all.device)
    la, lb = la.to(T_all.dtype), lb.to(T_all.dtype)
    Ta, Tb = T_all[:, fa], T_all[:, fb]                    # (B, P, 4, 4)
    ca = geom.mv(Ta[..., :3, :3], la.mean(dim=-2)) + Ta[..., :3, 3]
    cb = geom.mv(Tb[..., :3, :3], lb.mean(dim=-2)) + Tb[..., :3, 3]
    d0_cap = cap_po - cap_pl
    degenerate = torch.sum(d0_cap * d0_cap, dim=-1, keepdim=True) < 1e-8
    d0 = torch.where(degenerate, cb - ca, d0_cap)
    pl, po, n, dist, _ = gjk.closest_points(
        _posed_support(la, Ta), _posed_support(lb, Tb), d0, iters=iters)
    near = dist <= 5e-4
    n3 = near[..., None]
    return (torch.where(n3, cap_pl, pl), torch.where(n3, cap_po, po),
            torch.where(n3, cap_n, n),
            torch.where(near, torch.minimum(cap_d, dist), dist))
