"""Branchless GJK on tensors: the Johnson subalgorithm, the support
functions of the exact-hull collision tier and the fixed-iteration simplex
solver `closest_points`.

The port's `rmp_tpu/ops/gjk.py` (`_johnson`, `support_hull`,
`support_capsule`, `support_cylinder_unit`, `closest_points`) and part of
the TPU kernel `rmp_tpu/ops/pallas_gjk.py` (the mask-average hull support
of `_kernel`). The arithmetic of the kernel's pieces follows the kernel's:
3-vectors are dotted component by component in index order, and
normalisations multiply by the reciprocal `1 / (|v| + 1e-12)` (not rsqrt:
for near-axis-parallel directions the rsqrt form moves a cylinder's end-cap
witness by O(r)). `closest_points` runs in plain PyTorch, as the JAX
package runs it in XLA outside any Pallas kernel (the hull-vs-hull queries
of `sim/collision.robot_self_distances_hull`). Every function broadcasts
over leading axes.

Derivatives: autograd through `support_hull` and `support_hull_avg` is
already the envelope rule of the JAX package's `support_hull` custom_jvp
(`rmp_tpu/ops/gjk.py:92-113`), so no Function stands in for it. The
maximiser is chosen by comparisons (`argmax`, `==` against `amax`), which
carry no gradient, so ∂s/∂d = 0; the gather (first maximiser) and the mask
average (`eq` and its count are constants) pass ∂s/∂verts to the selected
rows only, the tie-averaged selection in the average's case. The
`1 / (|v| + 1e-12)` normalisations lie in the capsule and cylinder
supports, which the JAX package differentiates by autodiff too.
"""
from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-12
_FEAS = -1e-6     # barycentric feasibility slack


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a · b over the last axis (3), summed in index order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


_SUBSETS: dict[tuple, tuple] = {}


def _subsets(newest_only: bool, device):
    """The vertex subsets of the enumeration as device index tensors: the
    singles, the pairs' (i, j), the triples' (i, j, k), and the flat
    indices (4 a + b) of the Gram entries each subset reads, by name,
    built once per (newest_only, device)."""
    key = (newest_only, str(device))
    hit = _SUBSETS.get(key)
    if hit is None:
        singles = ((0,),) if newest_only else ((0,), (1,), (2,), (3,))
        pairs = (((0, 1), (0, 2), (0, 3)) if newest_only
                 else ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)))
        triples = (((0, 1, 2), (0, 1, 3), (0, 2, 3)) if newest_only
                   else ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)))
        flat = {}
        for name, subsets in (("p", pairs), ("t", triples)):
            idx = np.asarray(subsets).T                       # (size, S)
            for a in range(idx.shape[0]):
                for b in range(a, idx.shape[0]):
                    flat[f"{name}{a}{b}"] = torch.as_tensor(
                        4 * idx[a] + idx[b], dtype=torch.long, device=device)
        hit = _SUBSETS[key] = tuple(
            torch.as_tensor(t, dtype=torch.long, device=device).T
            for t in (singles, pairs, triples)) + (flat,)
    return hit


# the tetrahedron's Cramer terms P Q - R S over the edge Gram matrix g
# (flattened row-major): for each of u, v, w the factors of b0, b1, b2
# (the b0 column is the first row of cofactors, c00, c01, c02)
_CRAMER = (((4, 8, 5, 7), (2, 7, 1, 8), (1, 5, 2, 4)),     # u
           ((5, 6, 3, 8), (0, 8, 2, 6), (2, 3, 0, 5)),     # v
           ((3, 7, 4, 6), (1, 6, 0, 7), (0, 4, 1, 3)))     # w
_CRAMER_IDX: dict[str, tuple] = {}


def _cramer_terms(device):
    hit = _CRAMER_IDX.get(str(device))
    if hit is None:
        flat = np.asarray(_CRAMER).reshape(9, 4).T
        hit = _CRAMER_IDX[str(device)] = tuple(
            torch.as_tensor(np.ascontiguousarray(c), dtype=torch.long,
                            device=device) for c in flat)
    return hit


def johnson(Y: torch.Tensor, newest_only: bool = False,
            divide: bool = False):
    """Closest point of conv(Y) to the origin, branchless.

    Y: (..., 4, 3) simplex slots (duplicates allowed: degenerate subsets are
    masked infeasible by scale-aware Gram guards). Returns (x (..., 3),
    lam (..., 4)): the closest point and its barycentric weights. Every
    feasible vertex subset is projected and the feasible candidate of least
    norm is kept; on equal norms the first in enumeration order stays
    (singles, pairs, triples, the whole simplex; a where-chain with a
    strict `<`, taken here as the first minimum of the stacked
    candidates). newest_only=True enumerates only the subsets that hold
    slot 0, the newest support in the GJK loop. divide=True solves the
    triangles by division, as the JAX package's XLA `_johnson` does (the
    kernel's form, the default, multiplies by the reciprocal). The
    subsets of each size are computed side by side, each entry with the
    arithmetic of its own subset."""
    single, pair, triple, flat = _subsets(newest_only, Y.device)
    G = dot3(Y[..., :, None, :], Y[..., None, :, :]).flatten(-2)  # (..., 16)

    def d(name):                          # a Gram entry of every subset
        return G.index_select(-1, flat[name])

    def y(a):                                     # (..., S, 3)
        return Y.index_select(-2, a)

    cands, feas_all, lams = [], [], []
    lead = Y.shape[:-2]

    def scattered(idx, values):                   # (..., S, 4) weights
        S = idx.shape[-1]
        out = torch.zeros(*lead, S, 4, dtype=Y.dtype, device=Y.device)
        return out.scatter(-1, idx.T.expand(*lead, S, idx.shape[0]),
                           torch.stack(values, dim=-1))

    (i1,) = single
    cands.append(y(i1))
    feas_all.append(torch.ones(*lead, i1.shape[0], dtype=torch.bool,
                               device=Y.device))
    lams.append(scattered(single, [torch.ones(*lead, i1.shape[0],
                                              dtype=Y.dtype,
                                              device=Y.device)]))

    i, j = pair
    e2 = d("p00") - 2 * d("p01") + d("p11")
    t = (d("p00") - d("p01")) / (e2 + _EPS)
    cands.append(y(i) + t[..., None] * (y(j) - y(i)))
    feas_all.append((e2 > 1e-12) & (t >= _FEAS) & (t <= 1 - _FEAS))
    lams.append(scattered(pair, [1 - t, t]))

    i, j, k = triple
    ii, ij, ik = d("t00"), d("t01"), d("t02")
    a11 = d("t11") - 2 * ij + ii
    a22 = d("t22") - 2 * ik + ii
    a12 = d("t12") - ij - ik + ii
    b1 = ij - ii
    b2 = ik - ii
    det = a11 * a22 - a12 * a12
    ok = torch.abs(det) > 1e-6 * a11 * a22 + 1e-20
    den = torch.where(ok, det, torch.ones_like(det))
    if divide:
        u = (-b1 * a22 + b2 * a12) / den
        v = (-a11 * b2 + a12 * b1) / den
    else:
        inv = 1.0 / den
        u = (-b1 * a22 + b2 * a12) * inv
        v = (-a11 * b2 + a12 * b1) * inv
    yi = y(i)
    cands.append(yi + (u[..., None] * (y(j) - yi)
                       + v[..., None] * (y(k) - yi)))
    feas_all.append(ok & (u >= _FEAS) & (v >= _FEAS) & (1 - u - v >= _FEAS))
    lams.append(scattered(triple, [1 - u - v, u, v]))

    # the full tetrahedron: explicit 3x3 Cramer on the Gram matrix of its
    # edges, the nine cofactor-like products P Q - R S side by side
    y0 = Y[..., 0, :]
    E = Y[..., 1:, :] - y0[..., None, :]                      # (..., 3, 3)
    g = dot3(E[..., :, None, :], E[..., None, :, :]).flatten(-2)  # (..., 9)
    b = -dot3(E, y0[..., None, :])                            # (..., 3)
    p_, q_, r_, s_ = _cramer_terms(Y.device)
    X = (g.index_select(-1, p_) * g.index_select(-1, q_)
         - g.index_select(-1, r_) * g.index_select(-1, s_))
    X = X.unflatten(-1, (3, 3))            # (u, v, w) x (b0, b1, b2) terms
    c0 = X[..., :, 0]                                          # c00 c01 c02
    det = (g[..., 0] * c0[..., 0] + g[..., 1] * c0[..., 1]
           + g[..., 2] * c0[..., 2])
    scale = g[..., 0] * g[..., 4] * g[..., 8]
    ok = torch.abs(det) > 1e-6 * scale + 1e-30
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    uvw = (b[..., None, 0] * X[..., 0] + b[..., None, 1] * X[..., 1]
           + b[..., None, 2] * X[..., 2]) * inv[..., None]     # (..., 3)
    u, v, w = uvw.unbind(-1)
    cands.append(torch.zeros_like(y0)[..., None, :])
    feas_all.append((ok & (u >= _FEAS) & (v >= _FEAS) & (w >= _FEAS)
                     & (1 - u - v - w >= _FEAS))[..., None])
    lams.append(torch.stack([1 - u - v - w, u, v, w], dim=-1)[..., None, :])

    x = torch.cat(cands, dim=-2)                              # (..., C, 3)
    lam = torch.cat(lams, dim=-2)                             # (..., C, 4)
    n2 = dot3(x, x)
    # a NaN norm is never taken, as `n2 < best` never holds for it
    n2 = torch.where(torch.cat(feas_all, dim=-1) & (n2 == n2), n2,
                     torch.full_like(n2, float("inf")))
    best, at = n2.min(dim=-1, keepdim=True)        # the first minimum
    none = torch.isinf(best)[..., None]      # nothing feasible and finite
    best_x = torch.where(none, 0.0, x.gather(-2, at[..., None].expand(
        *lead, 1, 3)))[..., 0, :]
    best_lam = torch.where(none, 0.0, lam.gather(-2, at[..., None].expand(
        *lead, 1, 4)))[..., 0, :]
    return best_x, best_lam


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


def support_sphere(c: torch.Tensor, r: torch.Tensor,
                   d: torch.Tensor) -> torch.Tensor:
    """Ball of centre c (..., 3) and radius r (...,): support in direction
    d, c + r d / (|d| + 1e-12), as the JAX package divides."""
    dn = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + _EPS)
    return c + r[..., None] * dn


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


def support_hull(verts: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Convex polytope support point, the first maximising vertex (the JAX
    package's tie rule on the TPU; its CPU/GPU lowering averages exact
    ties, which the padded tables' repeated first vertex turn into the
    same point). verts: (..., V, 3), d: (..., 3), broadcast over the
    leading axes."""
    dots = dot3(verts, d[..., None, :])                       # (..., V)
    k = dots.argmax(dim=-1, keepdim=True)                     # the first
    lead = dots.shape[:-1]
    return torch.gather(verts.expand(*lead, *verts.shape[-2:]), -2,
                        k[..., None].expand(*lead, 1, 3))[..., 0, :]


def closest_points(support_a, support_b, d0: torch.Tensor, iters: int = 16):
    """Minimum-norm point of A ⊖ B by simplex GJK with 4 fixed slots and
    `iters` fixed iterations (the JAX package's `closest_points`).

    support_a, support_b: fn(d) -> the world extreme point of each shape
    in direction d (broadcast over the batch); d0 (..., 3) a nonzero start
    direction (B's centre minus A's is enough). Returns (pos_on_a,
    pos_on_b, normal_on_b, distance, gap): distance = |pa - pb| >= 0, the
    normal points from B toward A, and the true distance lies in
    [distance - gap, distance].

    Each iteration solves the simplex with the subsets that hold slot 0,
    stops a query (its simplex frozen) once the support gap is at most
    1e-5 |x|² + 1e-12, evicts the slot of least barycentric weight (the
    first on a tie), moves the old slot 0 there and puts the new support
    in slot 0; the witness points on A and B ride along per slot."""
    sa0, sb0 = support_a(-d0), support_b(d0)
    batch = torch.broadcast_shapes(sa0.shape[:-1], sb0.shape[:-1])
    Ya = sa0.expand(*batch, 3)[..., None, :].repeat(
        *(1,) * len(batch), 4, 1)                             # (..., 4, 3)
    Yb = sb0.expand(*batch, 3)[..., None, :].repeat(*(1,) * len(batch), 4, 1)
    done = torch.zeros(batch, dtype=torch.bool, device=d0.device)
    # built on the device: a tensor copied from a list would wait on it
    slots = torch.arange(4, device=d0.device)
    slot0 = (slots == 0)[:, None]                             # (4, 1)
    for _ in range(iters):
        x, lam = johnson(Ya - Yb, newest_only=True, divide=True)
        sa, sb = support_a(-x), support_b(x)
        n2 = dot3(x, x)
        gap = n2 - dot3(x, sa - sb)
        done = done | (gap <= 1e-5 * n2 + 1e-12)
        is_min = lam <= lam.amin(dim=-1, keepdim=True)
        # the first least-weight slot (a scan over 4 slots costs more)
        first = is_min.to(torch.int8).argmax(dim=-1, keepdim=True)
        live = ~done[..., None, None]
        evict = ((slots == first) & is_min)[..., None] & live  # (..., 4, 1)
        Ya = torch.where(evict, Ya[..., 0:1, :], Ya)
        Yb = torch.where(evict, Yb[..., 0:1, :], Yb)
        put = slot0 & live
        Ya = torch.where(put, sa[..., None, :], Ya)
        Yb = torch.where(put, sb[..., None, :], Yb)
    x, lam = johnson(Ya - Yb, divide=True)
    pa = torch.sum(lam[..., None] * Ya, dim=-2)
    pb = torch.sum(lam[..., None] * Yb, dim=-2)
    dist = torch.linalg.vector_norm(x, dim=-1)
    n = x / (dist[..., None] + 1e-9)
    s = support_a(-x) - support_b(x)
    gap = torch.sum(x * (x - s), dim=-1) / (dist + 1e-9)
    return pa, pb, n, dist, gap
