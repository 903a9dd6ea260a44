"""The capsule (or hull) against mesh collision distance error.

The port's `experiments/collision_mesh_error.py`. The reference queries
PyBullet's GJK against the Panda's collision meshes; the port models every
link as capsules (models/specs) or, in the hull tier, as a decimated hull
(assets/panda_hulls.npz). Two measures of the error:

1. Per link, configuration-free: the signed distance of dense mesh surface
   samples (vertices, face centroids, edge midpoints) to the link's capsule
   set (positive: the mesh protrudes, so an obstacle distance can
   overestimate by up to that; negative: padding, a conservative
   underestimate). numpy, float64.
2. Sampled: random joint configurations x one random capsule obstacle
   each, `sim/collision.robot_obstacle_distances` (or `_hull`) on the
   port's device against a mesh-exact distance, the least over each link's
   surface samples of the point-to-obstacle distance, in float64 on the
   same device (`mesh_distances`). With --geometry hull also the hull
   query against its own hull's dense surface samples (the solver's
   error, separated pairs only).

Mesh files are read from --meshes, which has no default (MESHES_MISSING);
the report goes to --out or chiprun_out/collision_mesh_error[_hull].json,
never into reports/.

    python -m rmp_tpu_torch.experiments.collision_mesh_error
        [--configs 4096] [--seed 0] [--geometry capsule|hull]
        --meshes DIR [--out FILE] [--cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

# what the mesh tools say when --meshes is not given: the
# files they read are not in this repository
MESHES_MISSING = (
    "--meshes is required: the directory of the Panda's collision OBJs, "
    "urdf/franka_panda/meshes/collision in the reference's tree. Those "
    "meshes are not in this repository; they have to be added to it before "
    "the committed assets and reports can be fitted again (ROADMAP Queue 1)")

# link name -> (obj file, yaw rotation about z applied to the mesh)
MESH_OF_LINK = {
    **{f"panda_link{i}": (f"link{i}.obj", 0.0) for i in range(1, 8)},
    "panda_hand": ("hand.obj", 0.0),
    "panda_leftfinger": ("finger.obj", 0.0),
    # the reference's panda.urdf:303 turns the right finger's mesh by pi
    "panda_rightfinger": ("finger.obj", np.pi),
}


def load_obj(path):
    """(vertices (V, 3), faces (F, 3) int) of an OBJ, polygons
    fan-triangulated."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def link_mesh(meshes: str, link: str):
    """(vertices, faces) of a link's mesh in its collision frame (the yaw
    of MESH_OF_LINK applied)."""
    fname, yaw = MESH_OF_LINK[link]
    verts, faces = load_obj(os.path.join(meshes, fname))
    if yaw:
        cz, sz = np.cos(yaw), np.sin(yaw)
        verts = verts @ np.asarray([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]]).T
    return verts, faces


def surface_samples(verts, faces):
    """Vertices, face centroids and edge midpoints: a dense surface cover."""
    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    return np.concatenate([verts, (a + b + c) / 3, (a + b) / 2, (b + c) / 2,
                           (a + c) / 2], axis=0)


def point_segment_dist(p, s0, s1):
    """|p - the closest point of segment [s0, s1]| (..., N) for p
    (..., N, 3) and s0, s1 (..., 3)."""
    s0e = s0[..., None, :]
    de = (s1 - s0)[..., None, :]
    denom = np.maximum(np.sum(de * de, axis=-1, keepdims=True), 1e-12)
    t = np.clip(np.sum((p - s0e) * de, axis=-1, keepdims=True) / denom,
                0.0, 1.0)
    return np.linalg.norm(p - (s0e + t * de), axis=-1)


def signed_dist_to_capsules(points, caps):
    """The least over capsules of (point-to-segment distance - radius)."""
    best = None
    for cap in caps:
        d = point_segment_dist(points, np.asarray(cap.p0, np.float64),
                               np.asarray(cap.p1, np.float64)) - cap.radius
        best = d if best is None else np.minimum(best, d)
    return best


def surface_deviation(pts, caps) -> dict:
    """The configuration-free report of one link's samples against its
    capsules."""
    dev = signed_dist_to_capsules(pts, caps)
    return dict(n_surface_samples=int(pts.shape[0]),
                protrusion_max_m=round(float(dev.max()), 4),
                protrusion_frac=round(float((dev > 0).mean()), 4),
                padding_max_m=round(float(-dev.min()), 4),
                mean_abs_dev_m=round(float(np.abs(dev).mean()), 4))


def mesh_distances(T_all, link_pts, frames, p0, p1, radius,
                   chunk: int = 256) -> torch.Tensor:
    """(C, L) float64: per configuration and link, the least distance from
    the link's samples (link_pts[frame] (N, 3), link-local), posed by
    T_all[:, frame] (C, F, 4, 4), to the capsule obstacle (p0, p1 (C, 3),
    radius (C,)), on T_all's device in chunks of `chunk` configurations."""
    T_all = T_all.double()
    p0, p1, radius = p0.double(), p1.double(), radius.double()
    C = T_all.shape[0]
    out = torch.empty(C, len(frames), dtype=torch.float64,
                      device=T_all.device)
    for li, f in enumerate(frames):
        pts = torch.as_tensor(link_pts[f], dtype=torch.float64,
                              device=T_all.device)
        for c0 in range(0, C, chunk):
            sl = slice(c0, min(c0 + chunk, C))
            T = T_all[sl, f]
            world = torch.einsum("cij,nj->cni", T[:, :3, :3], pts) \
                + T[:, None, :3, 3]
            s0, de = p0[sl, None], (p1 - p0)[sl, None]
            denom = torch.clamp(torch.sum(de * de, -1, keepdim=True),
                                min=1e-12)
            t = torch.clamp(torch.sum((world - s0) * de, -1, keepdim=True)
                            / denom, 0.0, 1.0)
            d = torch.linalg.vector_norm(world - (s0 + t * de), dim=-1)
            out[sl, li] = torch.amin(d, dim=1) - radius[sl]
    return out


def hull_surface_samples(v: np.ndarray, levels: int = 3) -> np.ndarray:
    """Dense samples of the convex hull of v: its triangles subdivided
    `levels` times (without them the sampling gap on large faces reads as
    solver error)."""
    from scipy.spatial import ConvexHull

    v = np.unique(np.asarray(v, np.float64), axis=0)
    tri = v[ConvexHull(v).simplices]
    for _ in range(levels):
        a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
        ab, bc, ca = (a + b) / 2, (b + c) / 2, (c + a) / 2
        tri = np.concatenate([np.stack([a, ab, ca], 1),
                              np.stack([ab, b, bc], 1),
                              np.stack([ca, bc, c], 1),
                              np.stack([ab, bc, ca], 1)])
    return np.unique(tri.reshape(-1, 3), axis=0)


def sample_problem(model, configs: int, seed: int, device):
    """(q (C, n) float32, capsule obstacles (C, 1)): configurations uniform
    within the joint limits (numpy, seeded) and one cylinder each from the
    randomizer's sample space (a generator on `device`, seeded), its kind
    dropped: both oracles model it as a capsule."""
    from rmp_tpu_torch.sim import randomizer as rnd
    from rmp_tpu_torch.sim.collision import ObstacleSet

    rng = np.random.default_rng(seed)
    qs = rng.uniform(np.asarray(model.q_lower), np.asarray(model.q_upper),
                     size=(configs, model.n_q)).astype(np.float32)
    gen = torch.Generator(device=device).manual_seed(seed)
    obs = rnd.randomize_obstacles(gen, configs, 1)
    return (torch.as_tensor(qs, device=device),
            ObstacleSet(obs.p0, obs.p1, obs.radius))


def sampled_errors(model, link_pts, q, obstacles, geometry: str = "capsule"):
    """(d_ours, d_mesh, T_all): the port's link distances (C, L) in
    `geometry` and the mesh-exact ones, both float64, for configurations q
    (C, n) against one capsule obstacle each (C, 1), on q's device."""
    from rmp_tpu_torch.models import kinematics as K
    from rmp_tpu_torch.sim import collision

    query = (collision.robot_obstacle_distances_hull if geometry == "hull"
             else collision.robot_obstacle_distances)
    with torch.no_grad():
        T_all = K.fk_all(model, q)
        d_ours = query(model, T_all, obstacles)[3][..., 0].double()
        d_mesh = mesh_distances(T_all, link_pts, model.collision_frames,
                                obstacles.p0[:, 0], obstacles.p1[:, 0],
                                obstacles.radius[:, 0])
    return d_ours, d_mesh, T_all


def measure(meshes: str, configs: int = 4096, seed: int = 0,
            geometry: str = "capsule", device=None) -> dict:
    """The report of both measures on `device` (default: the card)."""
    from rmp_tpu_torch import default_device
    from rmp_tpu_torch.models import robots

    device = default_device(device)
    model = robots.franka_panda()
    t0 = time.perf_counter()
    link_pts, links = {}, {}
    for f in model.collision_frames:
        name = model.link_names[f]
        link_pts[f] = surface_samples(*link_mesh(meshes, name))
        links[name] = surface_deviation(link_pts[f], model.collision[f])
    q, obstacles = sample_problem(model, configs, seed, device)
    d_ours, d_mesh, T_all = sampled_errors(model, link_pts, q, obstacles,
                                           geometry)
    err = (d_ours - d_mesh).cpu().numpy()       # > 0: more clearance
    report = dict(
        configs=configs, geometry=geometry, device=str(device),
        per_link_surface_deviation=links,
        obstacle_distance_error=dict(
            overestimate_max_m=round(float(err.max()), 4),
            overestimate_p99_m=round(float(np.quantile(err, 0.99)), 4),
            underestimate_max_m=round(float(-err.min()), 4),
            mean_abs_m=round(float(np.abs(err).mean()), 4),
            per_link_overestimate_max_m={
                model.link_names[f]: round(float(err[:, li].max()), 4)
                for li, f in enumerate(model.collision_frames)}))
    if geometry == "hull":
        from rmp_tpu_torch.models.hulls import hulls_for

        hull_pts = {f: hull_surface_samples(v) for f, v in
                    zip(model.collision_frames, hulls_for(model))}
        d_hull = mesh_distances(T_all, hull_pts, model.collision_frames,
                                obstacles.p0[:, 0], obstacles.p1[:, 0],
                                obstacles.radius[:, 0]).cpu().numpy()
        # separated pairs only: on overlap the hull query hands off to the
        # capsule surrogate by design
        free = d_hull > 1e-3
        solver = np.abs(d_ours.cpu().numpy() - d_hull)[free]
        report["gjk_solver_error_vs_hull_oracle"] = dict(
            separated_pairs=int(free.sum()),
            max_m=round(float(solver.max()), 5),
            p99_m=round(float(np.quantile(solver, 0.99)), 5),
            mean_m=round(float(solver.mean()), 5))
    report["seconds"] = time.perf_counter() - t0
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--geometry", choices=("capsule", "hull"),
                    default="capsule")
    ap.add_argument("--meshes", default=None,
                    help="directory of the collision OBJs (MESH_OF_LINK)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    if args.meshes is None:
        ap.error(MESHES_MISSING)

    from rmp_tpu_torch.experiments.common import device_of, report_path

    report = measure(args.meshes, args.configs, args.seed, args.geometry,
                     device_of(args.cpu))
    suffix = "_hull" if args.geometry == "hull" else ""
    path = report_path(f"collision_mesh_error{suffix}.json", args.out)
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
