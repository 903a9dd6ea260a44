"""Branchless GJK pieces on tensors: the Johnson subalgorithm and the
support functions of the exact-hull collision tier.

The port's part of `rmp_tpu/ops/gjk.py` (`_johnson`, `support_capsule`,
`support_cylinder_unit`) and of the TPU kernel `rmp_tpu/ops/pallas_gjk.py`
(the mask-average hull support of `_kernel`). The arithmetic follows the
kernel's: 3-vectors are dotted component by component in index order, and
normalisations multiply by the reciprocal `1 / (|v| + 1e-12)` (not rsqrt:
for near-axis-parallel directions the rsqrt form moves a cylinder's end-cap
witness by O(r)). Every function broadcasts over leading axes.

`closest_points`, the first-argmax `support_hull` with its envelope
derivative and `support_sphere` are not ported yet.
"""
from __future__ import annotations

import torch

_EPS = 1e-12
_FEAS = -1e-6     # barycentric feasibility slack


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a · b over the last axis (3), summed in index order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def johnson(Y: torch.Tensor, newest_only: bool = False):
    """Closest point of conv(Y) to the origin, branchless.

    Y: (..., 4, 3) simplex slots (duplicates allowed: degenerate subsets are
    masked infeasible by scale-aware Gram guards). Returns (x (..., 3),
    lam (..., 4)): the closest point and its barycentric weights. Every
    feasible vertex subset is projected and the feasible candidate of least
    norm is kept; on equal norms the first in enumeration order stays
    (strict `<`). newest_only=True enumerates only the subsets that hold
    slot 0, the newest support in the GJK loop."""
    y = [Y[..., i, :] for i in range(4)]
    singles = ((0,),) if newest_only else ((0,), (1,), (2,), (3,))
    pairs = (((0, 1), (0, 2), (0, 3)) if newest_only
             else ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)))
    triples = (((0, 1, 2), (0, 1, 3), (0, 2, 3)) if newest_only
               else ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)))
    dots = {(i, j): dot3(y[i], y[j]) for i in range(4) for j in range(i, 4)}

    def d(i, j):
        return dots[(i, j) if i <= j else (j, i)]

    zero = torch.zeros_like(y[0][..., 0])
    best_n2 = torch.full_like(zero, float("inf"))
    best_x = torch.zeros_like(y[0])
    best_lam = [zero] * 4

    def consider(feas, x, lam_pairs, best_n2, best_x, best_lam):
        n2 = dot3(x, x)
        take = feas & (n2 < best_n2)
        lam = [zero] * 4
        for i, v in lam_pairs:
            lam[i] = v
        return (torch.where(take, n2, best_n2),
                torch.where(take[..., None], x, best_x),
                [torch.where(take, a, b) for a, b in zip(lam, best_lam)])

    best = (best_n2, best_x, best_lam)
    for (i,) in singles:
        best = consider(torch.ones_like(zero, dtype=torch.bool), y[i],
                        [(i, torch.ones_like(zero))], *best)
    for i, j in pairs:
        e2 = d(i, i) - 2 * d(i, j) + d(j, j)
        t = (d(i, i) - d(i, j)) / (e2 + _EPS)
        feas = (e2 > 1e-12) & (t >= _FEAS) & (t <= 1 - _FEAS)
        x = y[i] + t[..., None] * (y[j] - y[i])
        best = consider(feas, x, [(i, 1 - t), (j, t)], *best)
    for i, j, k in triples:
        a11 = d(j, j) - 2 * d(i, j) + d(i, i)
        a22 = d(k, k) - 2 * d(i, k) + d(i, i)
        a12 = d(j, k) - d(i, j) - d(i, k) + d(i, i)
        b1 = d(i, j) - d(i, i)
        b2 = d(i, k) - d(i, i)
        det = a11 * a22 - a12 * a12
        ok = torch.abs(det) > 1e-6 * a11 * a22 + 1e-20
        inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
        u = (-b1 * a22 + b2 * a12) * inv
        v = (-a11 * b2 + a12 * b1) * inv
        feas = ok & (u >= _FEAS) & (v >= _FEAS) & (1 - u - v >= _FEAS)
        x = y[i] + (u[..., None] * (y[j] - y[i]) + v[..., None] * (y[k] - y[i]))
        best = consider(feas, x, [(i, 1 - u - v), (j, u), (k, v)], *best)
    # full tetrahedron: explicit 3x3 Cramer on the Gram matrix of its edges
    e = [y[1] - y[0], y[2] - y[0], y[3] - y[0]]
    g = [[dot3(e[r], e[c]) for c in range(3)] for r in range(3)]
    b = [-dot3(e[r], y[0]) for r in range(3)]
    c00 = g[1][1] * g[2][2] - g[1][2] * g[2][1]
    c01 = g[1][2] * g[2][0] - g[1][0] * g[2][2]
    c02 = g[1][0] * g[2][1] - g[1][1] * g[2][0]
    det = g[0][0] * c00 + g[0][1] * c01 + g[0][2] * c02
    scale = g[0][0] * g[1][1] * g[2][2]
    ok = torch.abs(det) > 1e-6 * scale + 1e-30
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    u = (b[0] * c00
         + b[1] * (g[0][2] * g[2][1] - g[0][1] * g[2][2])
         + b[2] * (g[0][1] * g[1][2] - g[0][2] * g[1][1])) * inv
    v = (b[0] * c01
         + b[1] * (g[0][0] * g[2][2] - g[0][2] * g[2][0])
         + b[2] * (g[0][2] * g[1][0] - g[0][0] * g[1][2])) * inv
    w = (b[0] * c02
         + b[1] * (g[0][1] * g[2][0] - g[0][0] * g[2][1])
         + b[2] * (g[0][0] * g[1][1] - g[0][1] * g[1][0])) * inv
    feas = (ok & (u >= _FEAS) & (v >= _FEAS) & (w >= _FEAS)
            & (1 - u - v - w >= _FEAS))
    _, best_x, best_lam = consider(
        feas, torch.zeros_like(y[0]),
        [(0, 1 - u - v - w), (1, u), (2, v), (3, w)], *best)
    return best_x, torch.stack(best_lam, dim=-1)


def support_capsule(p0: torch.Tensor, p1: torch.Tensor, r: torch.Tensor,
                    d: torch.Tensor) -> torch.Tensor:
    """Capsule (segment p0-p1 plus a ball of radius r) support in direction
    d. p0, p1, d: (..., 3); r: (...,)."""
    inv_dn = 1.0 / (torch.sqrt(dot3(d, d)) + _EPS)
    end = torch.where((dot3(d, p1 - p0) > 0)[..., None], p1, p0)
    return end + (r * inv_dn)[..., None] * d


def support_cylinder_unit(p0: torch.Tensor, p1: torch.Tensor,
                          an: torch.Tensor, r: torch.Tensor,
                          d: torch.Tensor) -> torch.Tensor:
    """Flat-capped cylinder with axis p0 -> p1 (unit axis `an` precomputed)
    and radius r: support in direction d."""
    d_ax = dot3(d, an)
    d_perp = d - d_ax[..., None] * an
    inv_p = 1.0 / (torch.sqrt(dot3(d_perp, d_perp)) + _EPS)
    end = torch.where((d_ax > 0)[..., None], p1, p0)
    return end + r[..., None] * (inv_p[..., None] * d_perp)


def support_obstacle(p0, p1, an, r, is_cyl, d) -> torch.Tensor:
    """The K4 kernel's obstacle support: the cylinder where is_cyl (bool,
    (...,)), else the capsule."""
    return torch.where(is_cyl[..., None],
                       support_cylinder_unit(p0, p1, an, r, d),
                       support_capsule(p0, p1, r, d))


def support_hull_avg(verts: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Convex polytope support, K4's tie rule: the mean of every vertex
    whose dot with d equals the maximum (a convex combination of maximisers
    is a valid support point), as sum(eq * v) * (1 / count). verts:
    (..., V, 3), d: (..., 3), broadcast over the leading axes."""
    dots = dot3(verts, d[..., None, :])                       # (..., V)
    m = torch.amax(dots, dim=-1, keepdim=True)
    eq = (dots == m).to(verts.dtype)
    inv = 1.0 / torch.sum(eq, dim=-1, keepdim=True)
    return torch.sum(eq[..., None] * verts, dim=-2) * inv
