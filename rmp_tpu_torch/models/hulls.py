"""Convex-hull collision geometry tables (the exact-hull collision tier).

The port's part of `rmp_tpu/models/hulls.py`: `assets/panda_hulls.npz` holds,
per Panda collision link, a decimated convex hull of the reference collision
mesh in collision-frame local coordinates (96 vertices at most). `hulls_for`
stacks them into one (L, V, 3) float32 table in `model.collision_frames`
order, padding each link by repeating its first vertex (harmless under the
support max). The dual-arm Panda reuses the Panda's hulls: its links are the
same geometry under an L_ / R_ prefix. The synthetic hulls of the two-joint
robot and the UR5 are not ported yet.
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
