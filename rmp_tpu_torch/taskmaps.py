"""Taskmap algebra — composable maps from configuration space, batched.

The port's `rmp_tpu/taskmaps.py`: a taskmap maps q (B, n) to task
coordinates x (B, P, d); `ctx` is the policy's per-tick context (B-leading
tensors). An FK-rooted taskmap also exposes (model, frame_idx, post) so the
combine engine runs the FK once for all policies and differentiates only
the small post map; `post_trans` is the post map on frame translations
(B, L, 3) for maps that read nothing else. Any other map (from_function,
or a chain that does not start at an FK frame) is differentiated whole by
forward-mode autodiff (`differentiate`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from rmp_tpu_torch.models import kinematics
from rmp_tpu_torch.models.urdf import KinematicModel
from rmp_tpu_torch.ops import geom


@dataclasses.dataclass(frozen=True)
class Taskmap:
    """A taskmap: callable (q, ctx) -> x (B, P, d); see the module doc."""

    fn: Callable
    model: KinematicModel | None = None
    frame_idx: int | tuple | None = None
    post: Callable | None = None
    is_identity: bool = False
    # variant of fn on frame translations (B, L, 3) instead of flattened
    # 4x4s (B, L, 16), declared by maps that only read the translation
    trans_fn: Callable | None = None
    # translation-space counterpart of `post`, set by chain()
    post_trans: Callable | None = None
    # head maps whose post passes the frames through untouched
    post_passthrough: bool = False

    def __call__(self, q, ctx=None):
        return self.fn(q, ctx)

    @property
    def fk_rooted(self) -> bool:
        return self.post is not None


def identity() -> Taskmap:
    """q -> q, as a (B, 1, n) row."""
    return Taskmap(lambda q, ctx: q[:, None, :], is_identity=True)


def fk_frame(model: KinematicModel, frame: str | int) -> Taskmap:
    """q -> flattened world 4x4 of `frame`: (B, 1, 16)."""
    idx = model.frame_index(frame) if isinstance(frame, str) else frame

    def fn(q, ctx):
        return kinematics.fk_frame(model, q, idx).reshape(-1, 1, 16)
    return Taskmap(fn, model=model, frame_idx=idx,
                   post=lambda T16, ctx: T16, post_passthrough=True)


def from_function(forward_fn) -> Taskmap:
    """Wrap an arbitrary (v, ctx) -> (B, P, d) map; a Taskmap is returned
    as it is."""
    if isinstance(forward_fn, Taskmap):
        return forward_fn
    return Taskmap(forward_fn)


def multi_fk_frames(model: KinematicModel, frames) -> Taskmap:
    """q -> flattened world 4x4s of several frames: (B, L, 16)."""
    idxs = tuple(model.frame_index(f) if isinstance(f, str) else f
                 for f in frames)

    def fn(q, ctx):
        T_all = kinematics.fk_all(model, q)
        return T_all[:, list(idxs)].reshape(-1, len(idxs), 16)
    return Taskmap(fn, model=model, frame_idx=idxs,
                   post=lambda T16s, ctx: T16s, post_passthrough=True)


def frames_to_point_distance(link_field: str = "pos_on_link",
                             obstacle_field: str = "pos_on_obstacle") -> Taskmap:
    """(B, L, 16) frames -> (B, L*K, 1) distances to the per-(frame, pair)
    obstacle points of ctx (fields (B, L, K, 3), base frame).

    Frozen-offset trick of the reference: the body point is the frame
    origin plus a detached offset, so its Jacobian is that of a point
    rigidly attached to the frame origin (`.detach()` drops the tangent
    under torch.func.jvp, as stop_gradient does under jax.jvp)."""
    def dist(p, ctx):
        pos_on_link = ctx[link_field]                 # (B, L, K, 3)
        pos_on_obstacle = ctx[obstacle_field]
        B, L, K, _ = pos_on_link.shape
        p_joint = p[:, :, None, :].expand(B, L, K, 3)
        offset = (pos_on_link - p_joint).detach()
        critical = p_joint + offset
        d = torch.linalg.vector_norm(critical - pos_on_obstacle, dim=-1)
        return d.reshape(B, L * K, 1)

    def fn(x, ctx):
        B, L = x.shape[0], ctx[link_field].shape[1]
        return dist(x.reshape(B, L, 4, 4)[..., :3, 3], ctx)
    return Taskmap(fn, trans_fn=dist)


def frames_relative_points(ctx_field: str = "relative_position") -> Taskmap:
    """(B, L, 16) frames -> (B, L*K, 3): the world positions of each frame's
    K offsets ctx[ctx_field] (B, L, K, 3), given in the frame's own
    coordinates (x = R off + t)."""
    def fn(x, ctx):
        offs = ctx[ctx_field]                         # (B, L, K, 3)
        B, L, K, _ = offs.shape
        T = x.reshape(B, L, 1, 4, 4)
        R = T[..., :3, :3].expand(B, L, K, 3, 3)
        p = geom.mv(R, offs) + T[..., :3, 3]
        return p.reshape(B, L * K, 3)
    return Taskmap(fn)


def _frames(x: torch.Tensor) -> torch.Tensor:
    """(B, P, 16) flattened 4x4s as (B, P, 4, 4)."""
    return x.reshape(*x.shape[:-1], 4, 4)


def frames_relative_offsets(ctx_field: str = "relative_position") -> Taskmap:
    """(B, L, 16) frames -> (B, L*K, 16): each frame composed with its K
    pure-translation offsets ctx[ctx_field] (B, L, K, 3), given in the
    frame's own coordinates; the grouped form of relative_offsets."""
    def fn(x, ctx):
        offs = ctx[ctx_field]                         # (B, L, K, 3)
        B, L, K, _ = offs.shape
        eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(
            B, L, K, 3, 3)
        T = x.reshape(B, L, 1, 4, 4) @ geom.hom(eye, offs)
        return T.reshape(B, L * K, 16)
    return Taskmap(fn)


def relative_offsets(ctx_field: str = "relative_position") -> Taskmap:
    """(B, 1, 16) frame -> (B, P, 16): the frame composed with P
    pure-translation offsets ctx[ctx_field] (B, P, 3), given in the frame."""
    def fn(x, ctx):
        offs = ctx[ctx_field]                         # (B, P, 3)
        eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(
            *offs.shape[:-1], 3, 3)
        T = _frames(x) @ geom.hom(eye, offs)          # (B, P, 4, 4)
        return T.reshape(*offs.shape[:-1], 16)
    return Taskmap(fn)


def relative_points(ctx_field: str = "relative_position") -> Taskmap:
    """(B, 1, 16) frame -> (B, P, 3): the world positions of P offsets
    ctx[ctx_field] (B, P, 3) given in the frame, x = R off + t; the fused
    form of chain(relative_offsets, to_position), with the same derivatives.
    It reads the rotation, so a chain through it takes the full 16 rows."""
    def fn(x, ctx):
        offs = ctx[ctx_field]                         # (B, P, 3)
        T = _frames(x)                                # (B, 1, 4, 4)
        R = T[..., :3, :3].expand(*offs.shape[:-1], 3, 3)
        return geom.mv(R, offs) + T[..., :3, 3]
    return Taskmap(fn)


def frame_to_point_distance(link_field: str = "pos_on_link",
                            obstacle_field: str = "pos_on_obstacle"
                            ) -> Taskmap:
    """(B, 1, 16) frame -> (B, P, 1) distances from per-pair body points to
    per-pair obstacle points (ctx fields (B, P, 3), base frame): the
    per-frame form of frames_to_point_distance, with the same frozen offset
    (`.detach()`), so the body point moves as if rigidly attached to the
    frame origin."""
    def dist(p, ctx):
        pos_on_link = ctx[link_field]                 # (B, P, 3)
        p_joint = p[:, :1, :].expand_as(pos_on_link)
        offset = (pos_on_link - p_joint).detach()
        critical = p_joint + offset
        d = torch.linalg.vector_norm(critical - ctx[obstacle_field], dim=-1)
        return d[..., None]

    def fn(x, ctx):
        return dist(_frames(x)[..., :3, 3], ctx)
    return Taskmap(fn, trans_fn=dist)


def to_position() -> Taskmap:
    """(B, P, 16) flattened 4x4 -> (B, P, 3) translation."""
    def fn(x, ctx):
        return x.reshape(*x.shape[:-1], 4, 4)[..., :3, 3]
    return Taskmap(fn, trans_fn=lambda p, ctx: p)


def to_euler() -> Taskmap:
    """(B, P, 16) flattened 4x4 -> (B, P, 3) extrinsic-XYZ euler angles."""
    def fn(x, ctx):
        return geom.euler_from_rotation_matrix(_frames(x)[..., :3, :3])
    return Taskmap(fn)


def to_quaternion() -> Taskmap:
    """(B, P, 16) flattened 4x4 -> (B, P, 4) quaternion (x, y, z, w), by the
    branch-free Shepperd conversion."""
    def fn(x, ctx):
        return geom.quaternion_from_rotation_matrix(_frames(x)[..., :3, :3])
    return Taskmap(fn)


def to_rotation6() -> Taskmap:
    """(B, P, 16) flattened 4x4 -> (B, P, 6): the first two rotation columns,
    a continuous rotation coordinate (no euler wrap, no quaternion double
    cover)."""
    def fn(x, ctx):
        R = _frames(x)[..., :3, :3]
        return torch.cat([R[..., :, 0], R[..., :, 1]], dim=-1)
    return Taskmap(fn)


def chain(*maps) -> Taskmap:
    """Compose taskmaps left to right: chain(f, g)(q, ctx) = g(f(q, ctx), ctx).

    An FK-rooted head keeps the composite FK-rooted, the tail folded into
    `post`; when the head passes frames through and the first tail map
    reads only translations, the composite also gets `post_trans`, so the
    combine engine propagates 3-row FK derivative blocks instead of 16-row
    ones."""
    maps = tuple(from_function(m) for m in maps)

    def fn(v, ctx):
        for m in maps:
            v = m.fn(v, ctx)
        return v

    head, tail = maps[0], maps[1:]
    if not head.fk_rooted:
        return Taskmap(fn)

    def post(T16, ctx):
        v = head.post(T16, ctx)
        for m in tail:
            v = m.fn(v, ctx)
        return v

    post_trans = None
    if head.post_passthrough and tail and tail[0].trans_fn is not None:
        def post_trans(p3, ctx):
            v = tail[0].trans_fn(p3, ctx)
            for m in tail[1:]:
                v = m.fn(v, ctx)
            return v
    return Taskmap(fn, model=head.model, frame_idx=head.frame_idx,
                   post=post, post_trans=post_trans)


def differentiate(taskmap_fn, q: torch.Tensor, qd: torch.Tensor, ctx=None):
    """(x, ẋ, J, c) of a taskmap at (q, q̇) (B, n): shapes (B, P, d),
    (B, P, d), (B, P, d, n), (B, P, d), by forward-mode autodiff
    (models/kinematics.differentiate)."""
    return kinematics.differentiate(lambda qq: taskmap_fn(qq, ctx), q, qd)
