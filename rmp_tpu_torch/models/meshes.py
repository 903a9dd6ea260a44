"""Visual triangle-mesh assets for the native renderer: the port's
rmp_tpu/models/meshes.py (numpy only; the same asset and layout).

assets/panda_visual.npz holds, per Panda link, the reference's OBJ visual
mesh (reference urdf/franka_panda/meshes/visual/*.obj, what the PyBullet
GUI draws — reference simulation.py:296-300) in link-local coordinates with
the URDF <visual><origin> baked in, packed by
experiments/pack_visual_meshes.py. Purely cosmetic: collision/physics use
the capsule or exact-hull geometry (models/hulls.py).

`visual_meshes_for(model)` returns (meshes, instances) aligned with the
model's frames, or None when the robot has no visual asset:
  meshes:    list of dicts {verts (V, 3) f32, normals (V, 3) f32 unit,
             tris (T, 3) i32} — one per asset link, shared by instances;
  instances: list of (mesh_index, frame_index) with frame_index -1 for the
             robot BASE (the single-robot root link has no frame; its pose
             is the identity). Dual/multi-robot compositions reuse the
             single-robot asset through the same prefix alias as
             models/hulls.py (their base links ARE frames, via the fixed
             base-mount joints).

Vertex normals are recomputed here (area-weighted face-normal scatter) so
the packed asset only stores quantized float16 vertices + int32 triangles.
"""
from __future__ import annotations

import os

import numpy as np

from rmp_tpu_torch.models.urdf import KinematicModel

_ASSET_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          os.pardir, os.pardir, "assets")
_VISUAL_FILES = {"panda": "panda_visual.npz",
                 "panda_dual": "panda_visual.npz"}
_LINK_ALIASES = {"panda_dual": lambda link: link[2:]}
_CACHE: dict = {}


def _vertex_normals(verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals: the cross product of each face's edges
    (norm = 2x face area) scatter-added to its three corners."""
    fn = np.cross(verts[tris[:, 1]] - verts[tris[:, 0]],
                  verts[tris[:, 2]] - verts[tris[:, 0]])
    n = np.zeros_like(verts)
    for c in range(3):
        np.add.at(n, tris[:, c], fn)
    return n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12)


def visual_meshes_for(model: KinematicModel):
    """(meshes, instances) for the native renderer, or None (no asset)."""
    key = (model.name, tuple(model.link_names))
    if key in _CACHE:
        return _CACHE[key]
    result = None
    fname = _VISUAL_FILES.get(model.name)
    path = os.path.join(_ASSET_DIR, fname) if fname else None
    if path is not None and os.path.exists(path):
        alias = _LINK_ALIASES.get(model.name, lambda link: link)
        with np.load(path, allow_pickle=False) as data:
            asset_links = sorted(k[:-6] for k in data.files
                                 if k.endswith("_verts"))
            base_links = set(str(b) for b in data["_base_links"]) \
                if "_base_links" in data.files else set()
            meshes, mesh_idx = [], {}
            for link in asset_links:
                verts = np.asarray(data[f"{link}_verts"], np.float32)
                tris = np.asarray(data[f"{link}_tris"], np.int32)
                mesh_idx[link] = len(meshes)
                meshes.append(dict(verts=verts, tris=tris,
                                   normals=_vertex_normals(verts, tris)))
        instances, matched = [], set()
        for i, link in enumerate(model.link_names):
            name = link if link in mesh_idx else alias(link)
            if name in mesh_idx:
                instances.append((mesh_idx[name], i))
                matched.add(name)
        # root links have no frame in the single-robot model: identity pose
        for link in sorted(base_links - matched):
            if link in mesh_idx:
                instances.append((mesh_idx[link], -1))
        if instances:
            result = (meshes, instances)
    _CACHE[key] = result
    return result
