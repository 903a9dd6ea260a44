"""Multi-capsule fits of the Panda's collision meshes.

The port's `experiments/fit_capsules.py`: K capsules a link (K up to
--k-max, the first that meets --target-mm kept, else the best), fitted to
dense mesh surface samples by an asymmetric soft-Hausdorff loss:

    dev(x) = min_k (|x - seg_k| - r_k)      signed; > 0 outside all capsules
    loss   = w_out softmax+(dev) + w_in softmax+(-dev) + w_bulge softmax+(h)

where h is how far samples of each capsule's surface lie outside the
mesh's convex hull: a capsule could otherwise overshoot past the mesh's
end at no cost. Protrusion (the mesh outside the capsules: an obstacle
distance overestimates) weighs more than padding. Start: k-means of the
samples and a principal axis a cluster (numpy); refinement: Adam at lr
3e-3 on (p0, p1, log r) in torch, on the card unless --cpu.

Prints a `_PANDA_CAPS` table for models/specs.py and each link's fit.
Meshes come from --meshes, which has no default (the reference's
collision meshes are not in the repository: MESHES_MISSING in
collision_mesh_error); the table also goes to --out (default
chiprun_out/fit_capsules.json), never into models/ or reports/.

    python -m rmp_tpu_torch.experiments.fit_capsules [--k-max 3]
        [--steps 600] [--target-mm 10] [--links L1,L2] --meshes DIR
        [--out FILE] [--cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from rmp_tpu_torch.experiments.collision_mesh_error import (MESH_OF_LINK,
                                                            MESHES_MISSING,
                                                            link_mesh,
                                                            surface_samples)


def kmeans(pts, k, iters=30, seed=0):
    rng = np.random.default_rng(seed)
    centers = pts[rng.choice(len(pts), k, replace=False)]
    for _ in range(iters):
        d = np.linalg.norm(pts[:, None] - centers[None], axis=-1)
        lab = d.argmin(1)
        for j in range(k):
            sel = pts[lab == j]
            if len(sel):
                centers[j] = sel.mean(0)
    return lab, centers


def init_capsules(pts, k, seed=0):
    """(k, 7) capsules p0 (3), p1 (3), r: per k-means cluster its
    principal axis over the 5-95% quantiles and its mean radius."""
    lab, _ = kmeans(pts, k, seed=seed)
    caps = []
    for j in range(k):
        sel = pts[lab == j]
        if len(sel) < 4:
            sel = pts
        c = sel.mean(0)
        _, _, vt = np.linalg.svd(sel - c, full_matrices=False)
        axis = vt[0]
        t = (sel - c) @ axis
        r0 = np.linalg.norm((sel - c) - t[:, None] * axis, axis=-1).mean()
        lo, hi = np.quantile(t, 0.05), np.quantile(t, 0.95)
        caps.append(np.concatenate([c + lo * axis, c + hi * axis,
                                    [max(r0, 1e-3)]]))
    return np.stack(caps)


def hull_planes(pts):
    """(A, b) with A x <= b inside the convex hull of pts."""
    from scipy.spatial import ConvexHull
    eq = ConvexHull(pts).equations        # (F, 4): n·x + d <= 0 inside
    return eq[:, :3], -eq[:, 3]


def _signed_dev(P, p0, p1, logr):
    r = torch.exp(logr)
    d = p1 - p0
    denom = torch.clamp(torch.sum(d * d, -1), min=1e-12)
    t = torch.clamp(torch.einsum("nkj,kj->nk", P[:, None] - p0[None], d)
                    / denom, 0.0, 1.0)
    closest = p0[None] + t[..., None] * d[None]
    dist = torch.linalg.vector_norm(P[:, None] - closest, dim=-1) - r[None]
    return torch.amin(dist, dim=1)


def _unit(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-9)


def _capsule_surface(p0, p1, logr, n_t=9, n_c=8):
    """Samples of every capsule's surface, end caps' tips included."""
    r = torch.exp(logr)
    d = p1 - p0
    axis = _unit(d)
    x = torch.tensor([1.0, 0.0, 0.0], device=d.device)
    y = torch.tensor([0.0, 1.0, 0.0], device=d.device)
    helper = torch.where(torch.abs(axis[:, :1]) < 0.9, x, y)
    u = _unit(torch.linalg.cross(axis, helper))
    v = torch.linalg.cross(axis, u)
    ts = torch.linspace(0.0, 1.0, n_t, device=d.device)
    ang = torch.arange(n_c, device=d.device) * (2 * np.pi / n_c)
    ring = (torch.cos(ang)[:, None, None] * u[None]
            + torch.sin(ang)[:, None, None] * v[None])        # (C, k, 3)
    seg = p0[None] + ts[:, None, None] * d[None]               # (T, k, 3)
    side = seg[:, None] + r[None, None, :, None] * ring[None]  # (T, C, k, 3)
    tips = torch.stack([p0 - r[:, None] * axis, p1 + r[:, None] * axis])
    return torch.cat([side.reshape(-1, 3), tips.reshape(-1, 3)])


def fit_link(pts, k, steps=600, w_out=4.0, w_in=1.0, w_bulge=4.0,
             tau=0.003, seed=0, device="cpu"):
    """(caps (k, 7), dev (N,), bulge): k capsules fitted to the samples
    pts (N, 3) by `steps` Adam steps at lr 3e-3 (float32 on `device`),
    the samples' signed deviations and the largest capsule overhang past
    the mesh hull (metres)."""
    P = torch.as_tensor(pts, dtype=torch.float32, device=device)
    A_np, b_np = hull_planes(pts)
    A = torch.as_tensor(A_np, dtype=torch.float32, device=device)
    b = torch.as_tensor(b_np, dtype=torch.float32, device=device)
    x0 = init_capsules(pts, k, seed=seed)
    prm = [torch.tensor(x, dtype=torch.float32, device=device,
                        requires_grad=True)
           for x in (x0[:, 0:3], x0[:, 3:6], np.log(x0[:, 6]))]

    def softplus_max(x):
        return tau * torch.logsumexp(torch.clamp(x, min=0.0) / tau, dim=0)

    def loss(p0, p1, logr):
        dev = _signed_dev(P, p0, p1, logr)
        S = _capsule_surface(p0, p1, logr)
        plane = torch.amax(S @ A.T - b[None], dim=-1)
        return (w_out * softplus_max(dev) + w_in * softplus_max(-dev)
                + w_bulge * softplus_max(plane))

    opt = torch.optim.Adam(prm, lr=3e-3)
    for _ in range(steps):
        opt.zero_grad()
        loss(*prm).backward()
        opt.step()
    with torch.no_grad():
        dev = _signed_dev(P, *prm).cpu().numpy().astype(np.float64)
        S = _capsule_surface(*prm).cpu().numpy().astype(np.float64)
    bulge = np.maximum(S @ A_np.T - b_np[None], 0.0).max()
    p0, p1, logr = (x.detach().cpu().numpy() for x in prm)
    return np.concatenate([p0, p1, np.exp(logr)[:, None]], -1), dev, bulge


def fit(meshes: str, links, k_max: int, steps: int, target_mm: float,
        device) -> dict:
    """{link: report} of the best fit for each link."""
    out = {}
    for link in links:
        t0 = time.perf_counter()
        pts = surface_samples(*link_mesh(meshes, link))
        best = None
        for k in range(1, k_max + 1):
            caps, dev, bulge = fit_link(pts, k, steps=steps, device=device)
            score = (float(dev.max()), float(bulge))
            if best is None or max(score) < max(best[2]):
                best = (k, caps, score, dev)
            if max(score) * 1000 < target_mm:
                break
        k, caps, (pro, bulge), dev = best
        out[link] = dict(k=k, capsules=caps.tolist(),
                         protrude_mm=pro * 1000, bulge_mm=bulge * 1000,
                         mean_abs_dev_mm=float(np.abs(dev).mean()) * 1000,
                         samples=int(pts.shape[0]),
                         seconds=time.perf_counter() - t0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k-max", type=int, default=3)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--target-mm", type=float, default=10.0)
    ap.add_argument("--links", default=None,
                    help="comma-separated links (default: every link of "
                         "MESH_OF_LINK)")
    ap.add_argument("--meshes", default=None,
                    help="directory of the collision OBJs (MESH_OF_LINK)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    if args.meshes is None:
        ap.error(MESHES_MISSING)

    from rmp_tpu_torch.experiments.common import device_of, report_path

    links = args.links.split(",") if args.links else list(MESH_OF_LINK)
    device = device_of(args.cpu)
    fits = fit(args.meshes, links, args.k_max, args.steps, args.target_mm,
               device)
    print("_PANDA_CAPS = {")
    for link, r in fits.items():
        entries = ",\n        ".join(
            f'CollisionPrimitive("capsule", '
            f'({c[0]:.4f}, {c[1]:.4f}, {c[2]:.4f}), '
            f'({c[3]:.4f}, {c[4]:.4f}, {c[5]:.4f}), {c[6]:.4f})'
            for c in r["capsules"])
        print(f'    "{link}": (\n        {entries},\n    ),')
    print("}")
    print("\n# link  K  protrude_mm  bulge_mm  mean|dev|_mm  seconds")
    for link, r in fits.items():
        print(f"# {link:18s} {r['k']}  {r['protrude_mm']:8.1f} "
              f"{r['bulge_mm']:8.1f} {r['mean_abs_dev_mm']:8.1f} "
              f"{r['seconds']:8.2f}")
    with open(report_path("fit_capsules.json", args.out), "w") as f:
        json.dump(dict(device=str(device), steps=args.steps, links=fits), f,
                  indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
