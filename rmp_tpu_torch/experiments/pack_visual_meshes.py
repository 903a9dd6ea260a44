"""Pack a URDF's OBJ visual meshes into a compact NPZ asset.

The port's `experiments/pack_visual_meshes.py`. The reference draws its
OBJ visual meshes through PyBullet's renderer; the port's native ray
tracer can draw them too (`--geometry visual` in make_gifs and the
viewer, models/meshes.py) from `assets/<robot>_visual.npz`. Per URDF link
with a <visual><mesh>: its vertices in link coordinates with the
<visual><origin> baked in (float16, ~0.1 mm at arm scale) as
`<link>_verts`, its int32 triangles as `<link>_tris`; `_base_links` lists
the links no joint has as its child (posed at the identity). Normals are
recomputed at load.

The URDF comes from --urdf, which has no default (URDF_MISSING); the asset goes to --out (default
chiprun_out/panda_visual.npz), never into assets/.

    python -m rmp_tpu_torch.experiments.pack_visual_meshes --urdf FILE
        [--out FILE]
"""
from __future__ import annotations

import argparse
import os
import sys
from xml.etree import ElementTree

import numpy as np

# what main says when --urdf is not given: the file is not in this
# repository
URDF_MISSING = (
    "--urdf is required: the Panda's URDF, urdf/franka_panda/panda.urdf in "
    "the reference's tree, with its visual OBJs beside it. Those files are "
    "not in this repository; they have to be added to it before "
    "assets/panda_visual.npz can be packed again (ROADMAP Queue 1)")


def parse_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(vertices (V, 3) float64, triangles (T, 3) int32) of an OBJ's v and f
    records: polygons fan-triangulated, 1-based and negative indices."""
    verts, tris = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    tris.append([idx[0], idx[k], idx[k + 1]])
    return (np.asarray(verts, np.float64),
            np.asarray(tris, np.int32).reshape(-1, 3))


def _rpy_matrix(rpy) -> np.ndarray:
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = (np.cos(r), np.sin(r), np.cos(p), np.sin(p),
                              np.cos(y), np.sin(y))
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def pack(urdf: str, log=print) -> dict[str, np.ndarray]:
    """The asset's arrays for every link of `urdf` with a visual mesh
    (mesh paths relative to the URDF's directory, package:// dropped)."""
    root = ElementTree.parse(urdf).getroot()
    urdf_dir = os.path.dirname(os.path.abspath(urdf))
    child_links = {j.find("child").get("link") for j in root.findall("joint")}
    data: dict[str, np.ndarray] = {}
    base_links = []
    for link in root.findall("link"):
        name = link.get("name")
        vis = link.find("visual")
        mesh = None if vis is None else vis.find("geometry/mesh")
        if mesh is None:
            continue
        rel = mesh.get("filename").replace("package://", "")
        verts, tris = parse_obj(os.path.join(urdf_dir, rel))
        origin = vis.find("origin")
        if origin is not None:
            xyz = np.array([float(x) for x in
                            origin.get("xyz", "0 0 0").split()])
            rpy = [float(x) for x in origin.get("rpy", "0 0 0").split()]
            verts = verts @ _rpy_matrix(rpy).T + xyz
        data[f"{name}_verts"] = verts.astype(np.float16)
        data[f"{name}_tris"] = tris
        if name not in child_links:
            base_links.append(name)
        log(f"{name:24s} {len(verts):6d} verts {len(tris):6d} tris ({rel})")
    data["_base_links"] = np.asarray(base_links)
    return data


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--urdf", default=None,
                    help="the URDF whose visual meshes to pack")
    ap.add_argument("--out", default=None,
                    help="the asset's path (default "
                         "chiprun_out/panda_visual.npz)")
    args = ap.parse_args(argv)
    if args.urdf is None:
        ap.error(URDF_MISSING)

    from rmp_tpu_torch.experiments.common import report_path

    data = pack(args.urdf)
    path = report_path("panda_visual.npz", args.out)
    np.savez_compressed(path, **data)
    n_v = sum(len(v) for k, v in data.items() if k.endswith("_verts"))
    n_t = sum(len(v) for k, v in data.items() if k.endswith("_tris"))
    print(f"\n{len(data['_base_links'])} base link(s): "
          f"{list(data['_base_links'])}")
    print(f"total {n_v} verts / {n_t} tris -> {path} "
          f"({os.path.getsize(path) / 1e6:.2f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
