"""Convex-hull collision geometry tables (the exact-hull collision tier).

The port's part of `rmp_tpu/models/hulls.py`: `assets/panda_hulls.npz` holds,
per Panda collision link, a decimated convex hull of the reference collision
mesh in collision-frame local coordinates (96 vertices at most). `hulls_for`
stacks them into one (L, V, 3) float32 table in `model.collision_frames`
order, padding each link by repeating its first vertex (harmless under the
support max). The dual-arm Panda reuses the Panda's hulls: its links are the
same geometry under an L_ / R_ prefix. The two-joint robot and the UR5 have
no meshes: their tables are synthetic, built in numpy exactly as the JAX
package builds them (the two-joint robot's boxes and 24-gon prism, the UR5's
capsule polytopes), so both packages hold the same float32 vertices.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from rmp_tpu_torch.models.urdf import KinematicModel, model_cache

_ASSET_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          os.pardir, os.pardir, "assets")
_HULL_FILES = {"panda": "panda_hulls.npz",
               "panda_dual": "panda_hulls.npz"}
# a model's link name -> the asset's
_LINK_ALIASES = {"panda_dual": lambda link: link[2:]}
_TABLES: dict[tuple, tuple] = {}
_DEVICE_TABLES: dict[tuple, tuple] = {}


def _two_joint_hulls() -> dict[str, np.ndarray]:
    """The TwoJointRobot's primitive collision geometry as exact hulls:
    link_1 and link_2 are 1.0 x 0.1 x 0.05 boxes from x = 0 to 1 (8
    corners); link_23_cyl, a z-axis cylinder of radius 0.075 and length
    0.05, is a 24-gon prism (48 vertices)."""
    box = np.asarray([[x, y, z] for x in (0.0, 1.0) for y in (-0.05, 0.05)
                      for z in (-0.025, 0.025)], np.float32)
    ang = np.linspace(0.0, 2.0 * np.pi, 24, endpoint=False)
    ring = np.stack([0.075 * np.cos(ang), 0.075 * np.sin(ang)], axis=-1)
    cyl = np.concatenate([
        np.concatenate([ring, np.full((24, 1), z)], axis=-1)
        for z in (-0.025, 0.025)]).astype(np.float32)
    return {"link_1": box, "link_2": box, "link_23_cyl": cyl}


def _capsule_polytope(p0, p1, r, n_ring: int = 16) -> np.ndarray:
    """Inner polytope of the capsule p0 -> p1 of radius r: at each end the
    pole and rings of n_ring vertices at latitudes 0, 22.5, 45 and 67.5
    degrees, built in float64 and rounded to float32."""
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    a = p1 - p0
    norm = np.linalg.norm(a)
    a = a / norm if norm > 1e-12 else np.asarray([0.0, 0.0, 1.0])
    u = np.cross(a, [1.0, 0.0, 0.0])
    if np.linalg.norm(u) < 1e-6:
        u = np.cross(a, [0.0, 1.0, 0.0])
    u /= np.linalg.norm(u)
    v = np.cross(a, u)
    ang = np.linspace(0.0, 2.0 * np.pi, n_ring, endpoint=False)
    ring = np.outer(np.cos(ang), u) + np.outer(np.sin(ang), v)
    pts = []
    for p, sgn in ((p0, -1.0), (p1, 1.0)):
        pts.append(p + sgn * r * a)                       # pole
        for lat in (0.0, np.pi / 8, np.pi / 4, 3 * np.pi / 8):
            pts.append(p + sgn * np.sin(lat) * r * a
                       + np.cos(lat) * r * ring)
    return np.concatenate([np.atleast_2d(x) for x in pts]).astype(np.float32)


def _ur5_hulls() -> dict[str, np.ndarray]:
    """The UR5's capsule spec is its collision definition: each collision
    link's hull is the union of its capsules' inner polytopes."""
    from rmp_tpu_torch.models.specs import UR5_SPEC
    return {link.name: np.concatenate([
        _capsule_polytope(np.asarray(c.p0), np.asarray(c.p1), c.radius)
        for c in link.collision])
        for link in UR5_SPEC.links if link.collision}


_SYNTH_HULLS = {"TwoJointRobot": _two_joint_hulls, "UR5": _ur5_hulls}


def _assemble(data, model: KinematicModel) -> np.ndarray | None:
    """Pad per-link vertex lists to a common V and stack them in
    collision-frame order; None if a collision link has no hull."""
    alias = _LINK_ALIASES.get(model.name, lambda link: link)
    per_link = []
    for i in model.collision_frames:
        link = alias(model.link_names[i])
        if link not in data:
            return None
        per_link.append(np.asarray(data[link], np.float32))
    V = max(v.shape[0] for v in per_link)
    return np.stack([
        np.concatenate([v, np.repeat(v[:1], V - v.shape[0], axis=0)])
        for v in per_link])


def hulls_for(model: KinematicModel) -> np.ndarray | None:
    """(L, V, 3) float32 local hull vertices per collision frame, or None
    when the robot has no hull asset; read once per model."""
    def build():
        synth = _SYNTH_HULLS.get(model.name)
        if synth is not None:
            return _assemble(synth(), model)
        fname = _HULL_FILES.get(model.name)
        path = None if fname is None else os.path.join(_ASSET_DIR, fname)
        if path is None or not os.path.exists(path):
            return None
        with np.load(path) as data:
            return _assemble(data, model)
    return model_cache(_TABLES, model, (), build)


def hull_table(model: KinematicModel, device) -> torch.Tensor:
    """hulls_for(model) as a contiguous float32 tensor on `device`, built
    once per (model, device); raises when the robot has no hull asset."""
    def build():
        table = hulls_for(model)
        if table is None:
            raise ValueError(f"no hull asset for robot {model.name!r}; use "
                             "capsule collision")
        return torch.as_tensor(table, dtype=torch.float32,
                               device=device).contiguous()
    return model_cache(_DEVICE_TABLES, model, (str(device),), build)
