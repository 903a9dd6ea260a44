"""K4: batched link-hull vs capsule / flat-capped cylinder closest points, the
CUDA counterpart of `rmp_tpu/ops/pallas_gjk.py::gjk_hull_obstacles`.

Operands keep the TPU kernel's batch-minor layouts: verts (L, V, 3) link-local
hull tables; R (L, 3, 3, B), t (L, 3, B) link world poses; p0, p1, an, d0
(L, M, 3, B) per-pair obstacle segment ends, unit axis and start direction
(slot m of link l may hold another obstacle than slot m of link l'); radius,
is_cyl (L, M, 1, B). Outputs pa, pb (L, M, 3, B) witnesses on the link and on
the obstacle, and dist (L, M, B). A CPU tensor takes the plain PyTorch
version (`gjk_hull_obstacles_plain`); a CUDA tensor launches the kernel of
csrc/gjk_hull.cu or raises. Unlike the TPU kernel, the batch needs no
particular multiple.

Gradients: while any operand requires grad, the call goes through
`GjkHullObstacles`, a torch.autograd.Function on both devices (the CPU too
takes it, not autograd through the plain iterations, as the JAX package's
kernel path takes its custom_vjp in interpret mode). Its backward is the
JAX package's envelope rule `_gjk_bwd` (`pallas_gjk.py:386-423`) line for
line: the distance's exact a.e. derivative n · (dpa - dpb), the witnesses
by a rigid model with the active features held fixed, and zero cotangents
for verts, an, is_cyl and d0.
"""
from __future__ import annotations

import ctypes

import torch

from rmp_tpu_torch import _build
from rmp_tpu_torch.ops.gjk import (dot3, johnson, support_hull_avg,
                                   support_obstacle)

_ARGTYPES = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 13


def gjk_hull_obstacles_plain(verts, R, t, p0, p1, an, radius, is_cyl, d0,
                             iters: int = 10):
    """The plain PyTorch version of K4: the same algorithm on (L, M, B, 3)
    views of the operands (see csrc/gjk_hull.cu for the steps). Runs in the
    operands' dtype."""
    def vec(x):                                   # (L, M, 3, B) -> (L, M, B, 3)
        return x.permute(0, 1, 3, 2)

    Rm = R.permute(0, 3, 1, 2)[:, None]           # (L, 1, B, 3, 3)
    RmT = Rm.transpose(-1, -2)
    tv = t.permute(0, 2, 1)[:, None]              # (L, 1, B, 3)
    P0, P1, AN, D0 = vec(p0), vec(p1), vec(an), vec(d0)
    r = radius[:, :, 0]                           # (L, M, B)
    cyl = is_cyl[:, :, 0] > 0.5
    local = verts[:, None, None]                  # (L, 1, 1, V, 3)

    def sup_link(d):
        dl = dot3(RmT, d[..., None, :])           # R^T d
        sl = support_hull_avg(local, dl)
        return dot3(Rm, sl[..., None, :]) + tv    # R s + t

    def sup_obs(d):
        return support_obstacle(P0, P1, AN, r, cyl, d)

    sa0, sb0 = sup_link(-D0), sup_obs(D0)
    Ya, Yb = [sa0] * 4, [sb0] * 4
    done = torch.zeros_like(r, dtype=torch.bool)
    for _ in range(iters):
        x, lam = johnson(torch.stack([a - b for a, b in zip(Ya, Yb)], -2),
                         newest_only=True)
        sa, sb = sup_link(-x), sup_obs(x)
        n2 = dot3(x, x)
        gap = n2 - dot3(x, sa - sb)
        done = done | (gap <= 1e-5 * n2 + 1e-12)
        m = torch.minimum(torch.minimum(lam[..., 0], lam[..., 1]),
                          torch.minimum(lam[..., 2], lam[..., 3]))
        live = ~done
        taken = torch.zeros_like(live)
        old_a, old_b = Ya[0], Yb[0]
        for i in range(4):
            e = (lam[..., i] <= m) & ~taken
            taken = taken | e
            w = (e & live)[..., None]
            Ya[i] = torch.where(w, old_a, Ya[i])
            Yb[i] = torch.where(w, old_b, Yb[i])
        Ya[0] = torch.where(live[..., None], sa, Ya[0])
        Yb[0] = torch.where(live[..., None], sb, Yb[0])
    x, lam = johnson(torch.stack([a - b for a, b in zip(Ya, Yb)], -2))
    pa = torch.zeros_like(x)
    pb = torch.zeros_like(x)
    for i in range(4):
        pa = pa + lam[..., i, None] * Ya[i]
        pb = pb + lam[..., i, None] * Yb[i]
    dist = torch.sqrt(dot3(x, x))
    return vec(pa).contiguous(), vec(pb).contiguous(), dist


def distinct_rows(verts: torch.Tensor) -> list[int]:
    """Per link of verts (L, V, 3), the rows up to the last one whose bits
    differ from row 0's (at least 1). models/hulls.py pads each link's table
    by repeating row 0; the kernel counts these rows the same way, scans only
    them, and adds the padding as one multiple of row 0 where row 0 is a
    maximiser."""
    bits = verts.detach().cpu().contiguous().view(torch.int32)
    differs = (bits != bits[:, :1]).any(dim=-1)               # (L, V)
    last = torch.arange(1, bits.shape[1] + 1) * differs
    return [max(1, int(x)) for x in last.amax(dim=-1)]


def _check(verts, R, t, p0, p1, an, radius, is_cyl, d0):
    """(L, M, V, B) of valid operands; raises on any other dtype, shape or
    device mix, on every device."""
    named = dict(verts=verts, R=R, t=t, p0=p0, p1=p1, an=an, radius=radius,
                 is_cyl=is_cyl, d0=d0)
    for name, x in named.items():
        if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
            raise TypeError(f"gjk_hull_obstacles takes float32 tensors, got "
                            f"{getattr(x, 'dtype', type(x))} for {name}")
        if x.device != verts.device:
            raise ValueError(f"{name} on {x.device}, verts on {verts.device}")
    if verts.dim() != 3 or verts.shape[2] != 3 or verts.shape[1] < 1:
        raise ValueError(f"verts must be (L, V, 3), got {tuple(verts.shape)}")
    L, V = verts.shape[:2]
    if p0.dim() != 4:
        raise ValueError(f"p0 must be (L, M, 3, B), got {tuple(p0.shape)}")
    M, B = p0.shape[1], p0.shape[3]
    want = dict(R=(L, 3, 3, B), t=(L, 3, B), p0=(L, M, 3, B),
                p1=(L, M, 3, B), an=(L, M, 3, B), d0=(L, M, 3, B),
                radius=(L, M, 1, B), is_cyl=(L, M, 1, B))
    for name, shape in want.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"{name} must be {shape} for verts "
                             f"{tuple(verts.shape)} and p0 {tuple(p0.shape)}, "
                             f"got {tuple(named[name].shape)}")
    return L, M, V, B


def gjk_hull_obstacles(verts, R, t, p0, p1, an, radius, is_cyl, d0,
                       iters: int = 10):
    """(pa, pb, dist) of every (link, slot, env) pair; see the module doc."""
    args = (verts, R, t, p0, p1, an, radius, is_cyl, d0)
    if torch.is_grad_enabled() and any(x.requires_grad for x in args
                                       if isinstance(x, torch.Tensor)):
        return GjkHullObstacles.apply(_forward, int(iters), *args)
    return _forward(*args, iters=iters)


def envelope_cotangents(R, t, p0, p1, pa, pb, dist, pa_bar, pb_bar,
                        dist_bar):
    """The JAX package's `_gjk_bwd` rule: (R̄, t̄, p̄0, p̄1, r̄) from the
    outputs and their cotangents, in the kernel's batch-minor layouts."""
    eps = 1e-9
    n = (pa - pb) / (dist[:, :, None] + eps)          # (L, K, 3, B)
    g = dist_bar[:, :, None]                          # (L, K, 1, B)

    # link side: pa = R a_loc + t with a_loc = R^T (pa - t) held fixed
    w_a = n * g + pa_bar                              # (L, K, 3, B)
    rel = pa - t[:, None]                             # (L, K, 3, B)
    a_loc = torch.einsum("lrcb,lkrb->lkcb", R, rel)   # R^T rel
    t_bar = torch.sum(w_a, dim=1)                     # (L, 3, B)
    R_bar = torch.einsum("lkrb,lkcb->lrcb", w_a, a_loc)

    # obstacle side: pb = p0 + s (p1 - p0) + rho u with (s, rho, u) fixed;
    # s the axial projection of pb, clipped to the segment
    w_b = pb_bar - n * g                              # (L, K, 3, B)
    ax = p1 - p0
    len2 = torch.sum(ax * ax, dim=2, keepdim=True)
    s = torch.clamp(torch.sum((pb - p0) * ax, dim=2, keepdim=True)
                    / (len2 + eps), 0.0, 1.0)         # (L, K, 1, B)
    foot = p0 + s * ax
    off = pb - foot
    u = off / (torch.sqrt(torch.sum(off * off, dim=2, keepdim=True)) + eps)
    p0_bar = (1.0 - s) * w_b
    p1_bar = s * w_b
    r_bar = torch.sum(u * w_b, dim=2, keepdim=True)   # (L, K, 1, B)
    return R_bar, t_bar, p0_bar, p1_bar, r_bar


class GjkHullObstacles(torch.autograd.Function):
    """K4 with the envelope-rule backward (envelope_cotangents), around
    `forward(verts, ..., d0, iters=)`: the wrapper's forward (the kernel on
    CUDA, the plain version on the CPU), or the plain version in any
    dtype, which takes the same rule."""

    @staticmethod
    def forward(ctx, forward, iters, verts, R, t, p0, p1, an, radius, is_cyl,
                d0):
        pa, pb, dist = forward(verts, R, t, p0, p1, an, radius, is_cyl, d0,
                               iters=iters)
        ctx.save_for_backward(R, t, p0, p1, pa, pb, dist)
        return pa, pb, dist

    @staticmethod
    def backward(ctx, pa_bar, pb_bar, dist_bar):
        R, t, p0, p1, pa, pb, dist = ctx.saved_tensors
        R_bar, t_bar, p0_bar, p1_bar, r_bar = envelope_cotangents(
            R, t, p0, p1, pa, pb, dist, pa_bar, pb_bar, dist_bar)
        # verts, an, is_cyl and d0 get zero cotangents: None
        out = (None, None, None, R_bar, t_bar, p0_bar, p1_bar, None, r_bar,
               None, None)
        return tuple(g if w else None
                     for g, w in zip(out, ctx.needs_input_grad))


def _forward(verts, R, t, p0, p1, an, radius, is_cyl, d0, iters: int = 10):
    """K4's forward: the plain version on the CPU, the kernel on CUDA
    (counted), raising on anything else."""
    L, M, V, B = _check(verts, R, t, p0, p1, an, radius, is_cyl, d0)
    device = verts.device
    if device.type == "cpu":
        return gjk_hull_obstacles_plain(verts, R, t, p0, p1, an, radius,
                                        is_cyl, d0, iters)
    if device.type != "cuda":
        raise ValueError(f"no K4 kernel for device {device}")
    args = (verts, R, t, p0, p1, an, radius, is_cyl, d0)
    if not all(x.is_contiguous() for x in args):
        raise ValueError("gjk_hull_obstacles takes contiguous operands")
    pa = torch.empty(L, M, 3, B, dtype=torch.float32, device=device)
    pb = torch.empty_like(pa)
    dist = torch.empty(L, M, B, dtype=torch.float32, device=device)
    fn = _build.c_function("rmp_gjk_hull_f32", _ARGTYPES)
    rc = fn(device.index, L, M, V, B, int(iters),
            *(x.data_ptr() for x in args), pa.data_ptr(), pb.data_ptr(),
            dist.data_ptr(), _build.raw_stream(device))
    if rc == -1:
        raise ValueError(f"K4 takes 1 to 2048 hull vertices per link, got {V}")
    if rc != 0:
        raise RuntimeError(f"K4 gjk_hull_obstacles launch failed: CUDA error "
                           f"{rc}")
    gjk_hull_obstacles.launches += 1
    return pa, pb, dist


gjk_hull_obstacles.launches = 0
