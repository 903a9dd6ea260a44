"""RMP combination engine: pullback, accumulate, resolve — batched.

The port's `rmp_tpu/core.py`. Per tick and environment, every leaf policy
gives (a_i, M_i) on its task space x_i = phi_i(q); the engine pulls them
back to joint space and solves

    q̈ = (Σ J_iᵀ M_i J_i)⁺ Σ J_iᵀ M_i (a_i − c_i),    c_i = J̇_i q̇.

derivatives='analytic' (the default) differentiates the FK chain in closed
form once per tick (fk_bundle, through the K3 kernel wrapper); only each
policy's small post map sees forward-mode autodiff (torch.func), and a
taskmap that is neither FK-rooted nor the identity is differentiated whole.
derivatives='jacfwd' differentiates every policy's whole taskmap, FK
included, in one stacked forward-mode pass (no kernel): the generic path
the closed form is checked against.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
from torch.func import jvp, vmap

from rmp_tpu_torch import default_device
from rmp_tpu_torch.models.kinematics import (differentiate, fk_all,
                                             frame_indices)
from rmp_tpu_torch.ops import geom
from rmp_tpu_torch.ops.cuda_fk import fk_derivatives_batched
from rmp_tpu_torch.ops.linalg import cholesky_solve_unrolled, lu_solve_unrolled
from rmp_tpu_torch.taskmaps import reverse_mode


def _pullback(J, M, a, c):
    """f = Jᵀ M (a − c), A = Jᵀ M J, summed over the pair axis.

    J: (B, P, d, n); M: (B, P, d, d); a, c: (B, P, d) -> f (B, n),
    A (B, n, n)."""
    W = M @ J                                               # (B, P, d, n)
    JT = J.transpose(-1, -2)                                # (B, P, n, d)
    A = torch.sum(JT @ W, dim=1)
    f = torch.sum(geom.mv(JT, geom.mv(M, a - c)), dim=1)
    return f, A


def resolve(A: torch.Tensor, f: torch.Tensor, method: str = "pinv"):
    """q̈ = A⁺ f for A (B, n, n), f (B, n).

    'pinv' (Moore-Penrose, reference parity), 'solve' (unrolled pivoted LU,
    valid for indefinite metrics) or 'cholesky' (ridge-regularised PSD
    solve, valid only while the combined metric stays positive definite).

    'pinv' drops the singular values below 10 max(m, n) eps of the largest,
    the JAX package's cutoff (jnp.linalg.pinv's default), not torch's
    default of max(m, n) eps: on a rank-deficient metric (a lone EE target
    on the Panda has rank 3 of 9) the cutoff, not the solver, decides which
    noise directions q̈ amplifies."""
    if method == "pinv":
        rtol = 10.0 * max(A.shape[-2:]) * torch.finfo(A.dtype).eps
        return geom.mv(torch.linalg.pinv(A, rtol=rtol), f)
    if method == "solve":
        return lu_solve_unrolled(A, f)
    if method == "cholesky":
        return cholesky_solve_unrolled(A, f)
    raise ValueError(f"unknown resolve method: {method}")


def _post_chain(post, T_blk, Td_blk, Jcols, c_blk, ctx):
    """Chain (x, ẋ, J, c) of frame derivatives through a post map h:

        x = h(T)           ẋ = Dh[Ṫ]
        J = Dh ∘ J_T       c = Dh[T̈] + D²h[Ṫ, Ṫ]

    T_blk/Td_blk/c_blk: (B, L, r); Jcols: (B, L, r, n), r = 16 (full rows)
    or 3 (translation rows)."""
    def h(t):
        return post(t, ctx)

    x, xd = jvp(h, (T_blk,), (Td_blk,))
    J = vmap(lambda v: jvp(h, (T_blk,), (v,))[1],
             in_dims=-1, out_dims=-1)(Jcols)

    def g(t):
        return jvp(h, (t,), (Td_blk,))[1]
    _, quad = jvp(g, (T_blk,), (Td_blk,))
    c = jvp(h, (T_blk,), (c_blk,))[1] + quad
    return x, xd, J, c


class FkBundle:
    """One tick's FK derivatives of every frame — (T16, Td16, J16, c16) of
    the K3 kernel wrapper — with the row selections the taskmaps read."""

    def __init__(self, T16, Td16, J16, c16):
        self.T16, self.Td16, self.J16, self.c16 = T16, Td16, J16, c16

    def rows(self, frames, translation: bool):
        """(T, Ṫ, J, c) of the frames: (B, L, r), (B, L, r), (B, L, r, n),
        (B, L, r) with r = 3 translation rows (entries 3/7/11 of each
        flattened transform, the slice 3:12:4) or r = 16 full rows."""
        if len(frames) == 1:
            k = frames[0]
            out = tuple(t[:, k:k + 1] for t in
                        (self.T16, self.Td16, self.J16, self.c16))
        else:
            idx = frame_indices(frames, self.T16.device)
            out = tuple(t.index_select(1, idx) for t in
                        (self.T16, self.Td16, self.J16, self.c16))
        if translation:
            out = tuple(t[:, :, 3:12:4] for t in out)
        return out


def fk_bundle(policies, q, qd) -> dict[int, FkBundle]:
    """{id(model): FkBundle} for every distinct FK model under `policies`:
    one K3 launch per model and tick, shared by all policies and by the
    distance context (FkBundle.T16)."""
    return {mid: FkBundle(*fk_derivatives_batched(m, q, qd))
            for mid, m in _fk_models(policies).items()}


def _grad_live(q, qd, ctxs, fk) -> bool:
    """Whether reverse mode will differentiate this tick's taskmap
    derivatives: grad enabled and q, q̇, a context tensor or the FK bundle
    requiring it."""
    if not torch.is_grad_enabled():
        return False
    tensors = [q, qd] + [t for ctx in ctxs if isinstance(ctx, dict)
                         for t in ctx.values() if isinstance(t, torch.Tensor)]
    tensors += [b.T16 for b in (fk or {}).values()]
    return any(t.requires_grad for t in tensors)


def _taskmap_derivatives(policies, q, qd, ctxs, derivatives, fk):
    if derivatives not in ("jacfwd", "analytic"):
        raise ValueError(f"unknown derivatives {derivatives!r}")
    with reverse_mode(_grad_live(q, qd, ctxs, fk)):
        if derivatives == "jacfwd":
            return _taskmap_derivatives_jacfwd(policies, q, qd, ctxs)
        return _taskmap_derivatives_analytic(policies, q, qd, ctxs, fk=fk)


def _fk_models(policies) -> dict[int, Any]:
    """{id(model): model} of every FK model under `policies`."""
    models: dict[int, Any] = {}
    for p in policies:
        tmap = p.taskmap
        if tmap.fk_rooted:
            models.setdefault(id(tmap.model), tmap.model)
    return models


def _taskmap_derivatives_jacfwd(policies, q, qd, ctxs):
    """(x, ẋ, J, c) per policy by one stacked forward-mode pass over every
    policy's taskmap (models/kinematics.differentiate), with one fk_all per
    FK model shared by the FK-rooted maps."""
    models = _fk_models(policies)

    def stacked(qq):
        T16 = {mid: fk_all(m, qq).reshape(*qq.shape[:-1], m.n_frames, 16)
               for mid, m in models.items()}
        outs = []
        for p, ctx in zip(policies, ctxs):
            tmap = p.taskmap
            if tmap.fk_rooted:
                i = tmap.frame_idx
                frames = i if isinstance(i, tuple) else (i,)
                T = T16[id(tmap.model)]
                T = (T[:, frames[0]:frames[0] + 1] if len(frames) == 1 else
                     T.index_select(1, frame_indices(frames, T.device)))
                outs.append(tmap.post(T, ctx))
            else:
                outs.append(tmap(qq, ctx))
        return tuple(outs)

    return differentiate(stacked, q, qd)


def _taskmap_derivatives_analytic(policies, q, qd, ctxs, fk=None):
    """(x, ẋ, J, c) per policy: FK-rooted taskmaps from the closed-form FK
    rows plus their post map's autodiff, identity maps exactly, any other
    map by `differentiate` on its own."""
    if fk is None:
        fk = fk_bundle(policies, q, qd)
    B, n = q.shape
    eye = torch.eye(n, dtype=q.dtype, device=q.device).expand(B, 1, n, n)
    zeros = torch.zeros(B, 1, n, dtype=q.dtype, device=q.device)
    x_all, xd_all, J_all, c_all = [], [], [], []
    for p, ctx in zip(policies, ctxs):
        tmap = p.taskmap
        if tmap.fk_rooted:
            i = tmap.frame_idx
            frames = i if isinstance(i, tuple) else (i,)
            translation = tmap.post_trans is not None
            blk = fk[id(tmap.model)].rows(frames, translation)
            post = tmap.post_trans if translation else tmap.post
            x, xd, J, c = _post_chain(post, *blk, ctx)
        elif tmap.is_identity:
            x, xd, J, c = q[:, None, :], qd[:, None, :], eye, zeros
        else:
            x, xd, J, c = differentiate(lambda qq: tmap(qq, ctx), q, qd)
        x_all.append(x)
        xd_all.append(xd)
        J_all.append(J)
        c_all.append(c)
    return tuple(x_all), tuple(xd_all), tuple(J_all), tuple(c_all)


def policy_row_blocks(policies: Sequence, q: torch.Tensor, qd: torch.Tensor,
                      params: Sequence, ctxs: Sequence,
                      derivatives: str = "analytic", fk=None):
    """Per-policy dense pullback row blocks: ([J_b (B, R_b, n)],
    [W_b (B, R_b, n)], [v_b (B, R_b)]) with R_b = P_b d_b, W = M J and
    v = M (a − c) rows, an identity leaf's J the n x n identity. The
    combined system A = Σ J_bᵀ W_b, f = Σ J_bᵀ v_b is what
    ops/cuda_resolve.pullback_resolve_blocks (K2b) reads."""
    x_all, xd_all, J_all, c_all = _taskmap_derivatives(
        policies, q, qd, ctxs, derivatives, fk)
    B, n = q.shape
    Js, Ws, vs = [], [], []
    for p, prm, ctx, x, xd, J, c in zip(policies, params, ctxs, x_all, xd_all,
                                        J_all, c_all):
        a, M = p.accel_metric(prm, x, xd, ctx)
        Js.append(J.reshape(B, -1, n))
        Ws.append((M @ J).reshape(B, -1, n))
        vs.append(geom.mv(M, a - c).reshape(B, -1))
    return Js, Ws, vs


def policy_rows(policies: Sequence, q: torch.Tensor, qd: torch.Tensor,
                params: Sequence, ctxs: Sequence,
                derivatives: str = "analytic", fk=None):
    """The row-stacked form of policy_row_blocks: (J (B, R, n),
    W (B, R, n), v (B, R)), R = Σ R_b, the input of
    ops/cuda_resolve.pullback_resolve (K2a)."""
    Js, Ws, vs = policy_row_blocks(policies, q, qd, params, ctxs,
                                   derivatives, fk)
    return torch.cat(Js, dim=1), torch.cat(Ws, dim=1), torch.cat(vs, dim=1)


def policy_row_blocks_structured(policies: Sequence, q: torch.Tensor,
                                 qd: torch.Tensor, params: Sequence,
                                 ctxs: Sequence, derivatives: str = "analytic",
                                 fk=None):
    """(tags, blocks) of the structured per-policy pullback rows:

      'identity': (M (B, n, n), v (B, n))      J = I_n, no rows
      'scalar':   (J (B, R, n), m (B, R), v (B, R))   1-D task spaces
      'dense':    (J (B, R, n), W (B, R, n), v (B, R))

    with W = M J and v = M (a − c) rows — the input of
    ops/cuda_resolve.pullback_resolve_structured (K1). derivatives:
    'analytic' (fk: a precomputed fk_bundle) or 'jacfwd'."""
    x_all, xd_all, J_all, c_all = _taskmap_derivatives(
        policies, q, qd, ctxs, derivatives, fk)
    B, n = q.shape
    tags, blocks = [], []
    for p, prm, ctx, x, xd, J, c in zip(policies, params, ctxs, x_all, xd_all,
                                        J_all, c_all):
        a, M = p.accel_metric(prm, x, xd, ctx)
        if p.taskmap.is_identity:
            tags.append("identity")
            blocks.append((M.reshape(B, n, n), geom.mv(M, a - c).reshape(B, n)))
        elif x.shape[-1] == 1:
            tags.append("scalar")
            m = M.reshape(B, -1)                     # (B, P) scalar metrics
            blocks.append((J.reshape(B, -1, n), m, m * (a - c).reshape(B, -1)))
        else:
            tags.append("dense")
            blocks.append((J.reshape(B, -1, n), (M @ J).reshape(B, -1, n),
                           geom.mv(M, a - c).reshape(B, -1)))
    return tuple(tags), tuple(blocks)


def evaluate_policies(policies: Sequence, q: torch.Tensor, qd: torch.Tensor,
                      params: Sequence, ctxs: Sequence, method: str = "pinv",
                      derivatives: str = "analytic",
                      fk=None) -> torch.Tensor:
    """Combined RMP evaluation q̈ (B, n) by the per-policy pullback and
    core.resolve; derivatives 'analytic' or 'jacfwd', both exact."""
    x_all, xd_all, J_all, c_all = _taskmap_derivatives(
        policies, q, qd, ctxs, derivatives, fk)
    B, n = q.shape
    f_comb = torch.zeros(B, n, dtype=q.dtype, device=q.device)
    A_comb = torch.zeros(B, n, n, dtype=q.dtype, device=q.device)
    for p, prm, ctx, x, xd, J, c in zip(policies, params, ctxs, x_all, xd_all,
                                        J_all, c_all):
        a, M = p.accel_metric(prm, x, xd, ctx)
        if p.taskmap.is_identity:
            # J == I_n: Jᵀ M J = M and Jᵀ M (a − c) = M (a − c) exactly
            f_comb = f_comb + torch.sum(geom.mv(M, a - c), dim=1)
            A_comb = A_comb + torch.sum(M, dim=1)
            continue
        f, A = _pullback(J, M, a, c)
        f_comb = f_comb + f
        A_comb = A_comb + A
    return resolve(A_comb, f_comb, method)


def _on(tree, device):
    """A param dict (or None) with its tensors on `device`."""
    if tree is None:
        return None
    return {k: v.to(device) if isinstance(v, torch.Tensor) else v
            for k, v in tree.items()}


class RmpCore:
    """Registry of named policies and their combined evaluation, after the
    JAX package's RmpCore (the reference's add_rmp / remove_rmp_by_name /
    evaluate / __str__ surface). It runs on the card unless `device` says
    otherwise; the policies' params are moved there as they are gathered.
    derivatives: 'analytic' (closed-form FK through K3) or 'jacfwd'."""

    def __init__(self, rmps: dict | None = None, method: str = "pinv",
                 derivatives: str = "analytic", device=None):
        if derivatives not in ("analytic", "jacfwd"):
            raise ValueError(f"unknown derivatives {derivatives!r}")
        self.rmps: dict[str, Any] = dict(rmps) if rmps else {}
        self.method = method
        self.derivatives = derivatives
        self.device = default_device(device)

    def __str__(self) -> str:
        if not self.rmps:
            return "no RMPs in use.\n"
        out = "\nused RMPs:\n"
        for i, rmp in enumerate(self.rmps.values()):
            out += "\t".join([str(i), rmp.name, str(type(rmp))]) + "\n"
        return out

    def add_rmp(self, rmp) -> None:
        self.rmps[rmp.name] = rmp

    def remove_rmp_by_name(self, name: str) -> None:
        self.rmps.pop(name)

    @property
    def policies(self) -> tuple:
        return tuple(self.rmps.values())

    def gather_params(self) -> tuple:
        return tuple(_on(p.params, self.device) for p in self.policies)

    def make_evaluate(self):
        """fn(q, qd (B, n), params, ctxs) -> q̈ (B, n), batched."""
        policies, method = self.policies, self.method
        derivatives = self.derivatives

        def fn(q, qd, params, ctxs):
            return evaluate_policies(policies, q, qd, params, ctxs, method,
                                     derivatives)
        return fn

    def evaluate(self, q, qd, context: dict | None = None, params=None):
        """q̈ (n,) for one state q, q̇ (n,), run as a batch of one.

        context: policy name -> that policy's per-tick ctx, unbatched (the
        JAX package's per-env layout)."""
        if params is None:
            params = self.gather_params()
        f32 = dict(dtype=torch.float32, device=self.device)
        q = torch.as_tensor(q, **f32).reshape(1, -1)
        qd = torch.as_tensor(qd, **f32).reshape(1, -1)
        ctxs = tuple(
            None if ctx is None else
            {k: torch.as_tensor(v, device=self.device)[None]
             for k, v in ctx.items()}
            for ctx in ((context or {}).get(p.name) for p in self.policies))
        return self.make_evaluate()(q, qd, params, ctxs)[0]
