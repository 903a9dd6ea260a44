"""Decimated convex hulls of the Panda's collision meshes.

The port's `experiments/fit_hulls.py`: per collision link, at most
--max-verts vertices of the mesh's convex hull (collision-frame
coordinates, the frames of models/specs' capsules) whose hull
inner-approximates the mesh hull with a certified support error, the
geometry of the hull tier (K4). Greedy support-error selection: from the 6
axis extremes, add the hull vertex that best fixes the worst support
underestimate max_d [h_full(d) - h_subset(d)] over a Fibonacci lattice of
directions. The subset's hull lies inside the mesh hull, so a GJK
distance can only overestimate clearance, by at most that error. numpy
and scipy.

Meshes come from --meshes, which has no default (the reference's
collision meshes are not in the repository: MESHES_MISSING in
collision_mesh_error). The table goes to --out (default
chiprun_out/panda_hulls.npz) and the report beside it (hull_fit.json),
never into assets/ or reports/.

    python -m rmp_tpu_torch.experiments.fit_hulls [--max-verts 96]
        [--dirs 2048] --meshes DIR [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from rmp_tpu_torch.experiments.collision_mesh_error import (MESH_OF_LINK,
                                                            MESHES_MISSING,
                                                            link_mesh)


def fibonacci_directions(n: int) -> np.ndarray:
    """n roughly uniform unit directions (a spherical Fibonacci lattice)."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + 5.0 ** 0.5) * i
    return np.stack([np.sin(phi) * np.cos(theta),
                     np.sin(phi) * np.sin(theta),
                     np.cos(phi)], axis=-1)


def decimate_hull(verts: np.ndarray, max_verts: int, dirs: np.ndarray):
    """(subset (M, 3), support_error): M <= max_verts vertices of the
    convex hull of verts, chosen greedily, and the largest support
    underestimate over dirs (metres)."""
    from scipy.spatial import ConvexHull

    hull = ConvexHull(verts)
    hv = verts[hull.vertices]                      # (H, 3) hull vertices
    dots = hv @ dirs.T                             # (H, D)
    h_full = dots.max(axis=0)                      # (D,)

    chosen = set()
    for k in range(3):                             # the 6 axis extremes
        chosen.add(int(np.argmax(hv[:, k])))
        chosen.add(int(np.argmin(hv[:, k])))
    idx = sorted(chosen)
    h_sub = dots[idx].max(axis=0)
    while len(idx) < min(max_verts, len(hv)):
        gap = h_full - h_sub                       # (D,) >= 0
        d_worst = int(np.argmax(gap))
        if gap[d_worst] <= 1e-5:                   # 0.01 mm: done
            break
        # the vertex that best fixes the worst direction; on a numerical
        # tie with a chosen one, the next best
        cand = int(np.argmax(dots[:, d_worst]))
        if cand in chosen:
            order = np.argsort(-dots[:, d_worst])
            cand = next(int(c) for c in order if int(c) not in chosen)
        chosen.add(cand)
        idx = sorted(chosen)
        h_sub = np.maximum(h_sub, dots[cand])
    return hv[idx], float((h_full - h_sub).max())


def fit(meshes: str, max_verts: int, dirs: int):
    """({link: (M, 3) float32}, report) for every link of MESH_OF_LINK."""
    directions = fibonacci_directions(dirs)
    tables, report = {}, {}
    for link in MESH_OF_LINK:
        t0 = time.perf_counter()
        verts, _ = link_mesh(meshes, link)
        sub, err = decimate_hull(verts, max_verts, directions)
        tables[link] = sub.astype(np.float32)
        report[link] = dict(mesh_verts=int(verts.shape[0]),
                            hull_verts=int(sub.shape[0]),
                            support_error_mm=round(err * 1e3, 3),
                            seconds=time.perf_counter() - t0)
    return tables, report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-verts", type=int, default=96)
    ap.add_argument("--dirs", type=int, default=2048)
    ap.add_argument("--meshes", default=None,
                    help="directory of the collision OBJs (MESH_OF_LINK)")
    ap.add_argument("--out", default=None,
                    help="the table's path (default "
                         "chiprun_out/panda_hulls.npz)")
    args = ap.parse_args(argv)
    if args.meshes is None:
        ap.error(MESHES_MISSING)

    from rmp_tpu_torch.experiments.common import report_path

    tables, report = fit(args.meshes, args.max_verts, args.dirs)
    for link, r in report.items():
        print(f"{link:20s} mesh {r['mesh_verts']:6d} -> hull "
              f"{r['hull_verts']:3d} verts, support err "
              f"{r['support_error_mm']:.3f} mm ({r['seconds']:.2f} s)")
    path = report_path("panda_hulls.npz", args.out)
    np.savez_compressed(path, **tables)
    with open(report_path("hull_fit.json", os.path.join(
            os.path.dirname(path), "hull_fit.json")), "w") as f:
        json.dump(report, f, indent=2)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
