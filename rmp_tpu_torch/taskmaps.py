"""Taskmap algebra — composable maps from configuration space, batched.

The port's `rmp_tpu/taskmaps.py`, for the maps of the ported scenes: a
taskmap maps q (B, n) to task coordinates x (B, P, d); `ctx` is the policy's
per-tick context (B-leading tensors). An FK-rooted taskmap also exposes
(model, frame_idx, post) so the combine engine runs the FK once for all
policies and differentiates only the small post map; `post_trans` is the
post map on frame translations (B, L, 3) for maps that read nothing else.
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


def to_position() -> Taskmap:
    """(B, P, 16) flattened 4x4 -> (B, P, 3) translation."""
    def fn(x, ctx):
        return x.reshape(*x.shape[:-1], 4, 4)[..., :3, 3]
    return Taskmap(fn, trans_fn=lambda p, ctx: p)


def chain(*maps) -> Taskmap:
    """Compose taskmaps left to right: chain(f, g)(q, ctx) = g(f(q, ctx), ctx).

    An FK-rooted head keeps the composite FK-rooted, the tail folded into
    `post`; when the head passes frames through and the first tail map
    reads only translations, the composite also gets `post_trans`, so the
    combine engine propagates 3-row FK derivative blocks instead of 16-row
    ones."""
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
