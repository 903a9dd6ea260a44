"""K5: the whole v2 tick in one kernel, the CUDA counterpart of
`rmp_tpu/ops/pallas_tick.py`.

`make_fused_qdd(env, ridge=1e-6)` returns
fn(q (B, n), qd (B, n), goal (B, 3), obs_p0 (B, K, 3), obs_p1 (B, K, 3),
obs_r (B, K)) -> q̈ (B, n), float32, batch-first. Per env it runs the FK
twist recursion, the EE attractor, the identity-space leaves (velocity cap,
damping, c-space bias) and the grouped obstacle policy over every collision
frame x obstacle, pulls each back into A = Σ JᵀMJ and f = Σ JᵀM(a − c), and
solves with an unrolled Cholesky (ridge on the diagonal, pivot squares
clamped to 1e-12). A CPU tensor takes the plain PyTorch version
(`fused_qdd_plain`); a CUDA tensor launches csrc/fused_tick.cu or raises.
The JAX kernel needs B % 1024 == 0; the port takes any B. K5 has no
derivative rule, as JAX's `pallas_call` has none: `fused_qdd` raises while
grad is enabled and an input requires grad, on both devices.

Semantics of the reference kernel, kept as they are:
  - each collision frame contributes only its FIRST capsule
    (`model.collision[f][0]`), while the standard path takes the nearest of
    all of a link's capsules: K5 equals the standard q̈ of a model whose
    links keep their first capsule only;
  - the policy parameters are read once, when the fn is made (the env's
    bound params are not); only the goal comes per call;
  - the scalar constants are combined in float64 and rounded once to
    float32 (`FusedTick.consts`), as the JAX body folds Python floats;
  - the Cholesky has no pivoting, so an indefinite metric (the velocity
    cap's w / (1 − ratio²) near its singularity) gives garbage, possibly
    non-finite, where the standard path's pivoted LU gives a number.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from rmp_tpu_torch import _build
from rmp_tpu_torch.core import evaluate_policies
from rmp_tpu_torch.models.fk_derivatives import FkDerivatives
from rmp_tpu_torch.ops.cuda_fk import ancestor_table, model_tables
from rmp_tpu_torch.ops.linalg import cholesky_solve_unrolled
from rmp_tpu_torch.policies import v2
from rmp_tpu_torch.sim.collision import ObstacleSet, segment_closest_params
from rmp_tpu_torch.sim.world import SimState, sense

_ARGTYPES = [ctypes.c_int] * 8 + [ctypes.c_void_p] * 18

# offsets into FusedTick.consts, mirrored in csrc/fused_tick.cu
RIDGE = 0
ATT_P, ATT_D, ATT_EPS, ATT_SOFT, ATT_ALPHA_LS, ATT_ONE_MINUS_MIN_ALPHA, \
    ATT_MIN_ALPHA, ATT_BOOST_LS, ATT_BOOST, ATT_MAX_S, ATT_MIN_S = range(1, 12)
OBS_MARGIN, OBS_RMOD, OBS_RMOD_SQ, OBS_METRIC, OBS_EXPLODER_STD, \
    OBS_EXPLODER_EPS, OBS_REP_GAIN, OBS_REP_STD, OBS_GATE_LS, OBS_DAMP_GAIN, \
    OBS_DAMP_STD, OBS_ROBUST_EPS = range(12, 24)
IDENTITY_BASE = 24
# identity-space leaf codes; each has a block of consts at its offset:
#   VELCAP:  cutoff, region, clip (region − 1e-6), weight, gain
#   DAMPING: metric_scalar, inertia, accel_d_gain
#   CSPACE:  thresh, position_gain, damping_gain, metric_scalar + inertia,
#            goal (n)
VELCAP, DAMPING, CSPACE = 1, 2, 3


def supports(env) -> bool:
    """Whether this env's policy stack matches the fused-kernel template:
    an FK-rooted single-frame attractor, an FK-rooted multi-frame obstacle
    policy, and otherwise only identity-space v2 leaves
    (pallas_tick.supports)."""
    kinds = []
    for p in env.policies:
        fn = p.accel_metric
        if fn is v2._attractor_accel_metric:
            tm = p.taskmap
            if not (tm.fk_rooted and isinstance(tm.frame_idx, int)):
                return False
            kinds.append("attractor")
        elif fn in (v2._velocity_cap_accel_metric,
                    v2._joint_damping_accel_metric,
                    v2._cspace_biasing_accel_metric):
            kinds.append("identity")
        elif fn is v2._obstacle_accel_metric:
            tm = p.taskmap
            if not (tm.fk_rooted and isinstance(tm.frame_idx, tuple)):
                return False
            kinds.append("obstacle")
        else:
            return False
    return "attractor" in kinds and "obstacle" in kinds


@dataclasses.dataclass(eq=False)
class FusedTick:
    """What K5 reads of an env, fixed when the fn is made.

    caps (n_col, 7): p0, p1, radius of each collision frame's first capsule
    (link coordinates); consts: the policy constants, float32; identity:
    (leaf code, offset into consts) of each identity-space leaf in policy
    order."""

    model: object
    ee_frame: int
    col_frames: tuple[int, ...]
    caps: np.ndarray
    consts: np.ndarray
    identity: tuple[tuple[int, int], ...]
    _device_tables: dict = dataclasses.field(default_factory=dict,
                                             repr=False)

    def tables(self, device) -> dict[str, torch.Tensor]:
        """The env's tables on `device` as the kernel reads them, built once
        per device."""
        key = str(device)
        if key not in self._device_tables:
            self._device_tables[key] = dict(
                col_frames=torch.tensor(self.col_frames, dtype=torch.int32,
                                        device=device),
                caps=torch.tensor(self.caps, device=device),
                identity=torch.tensor(self.identity, dtype=torch.int32,
                                      device=device).reshape(-1),
                consts=torch.tensor(self.consts, device=device))
        return self._device_tables[key]


def fused_tick(env, ridge: float = 1e-6) -> FusedTick:
    """The FusedTick of `env`: its first attractor and first obstacle
    policy, every identity-space leaf in order (pallas_tick._make_kernel).
    Constants are combined in float64, as the JAX body folds Python floats
    at trace time, and rounded once to float32. Raises on an env that
    `supports` rejects."""
    if not supports(env):
        raise ValueError(f"env {env.name!r}: its policy stack does not match "
                         f"the fused-tick (K5) template")
    model = env.model
    pols = env.policies
    att = next(p for p in pols if p.accel_metric is v2._attractor_accel_metric)
    obs = next(p for p in pols if p.accel_metric is v2._obstacle_accel_metric)
    ap = {k: float(v) for k, v in att.params.items() if k != "goal"}
    op = {k: float(v) for k, v in obs.params.items()}
    col_frames = tuple(obs.taskmap.frame_idx)
    consts = [
        ridge,
        ap["accel_p_gain"], ap["accel_d_gain"], ap["accel_norm_eps"],
        ap["accel_norm_eps"] / 10.0, ap["metric_alpha_length_scale"],
        1.0 - ap["min_metric_alpha"], ap["min_metric_alpha"],
        ap["proximity_metric_boost_length_scale"],
        ap["proximity_metric_boost_scalar"], ap["max_metric_scalar"],
        ap["min_metric_scalar"],
        op["margin"], op["metric_modulation_radius"],
        op["metric_modulation_radius"] * op["metric_modulation_radius"],
        op["metric_scalar"], op["metric_exploder_std_dev"],
        op["metric_exploder_eps"], op["repulsion_gain"],
        op["repulsion_std_dev"], op["damping_velocity_gate_length_scale"],
        op["damping_gain"], op["damping_std_dev"],
        op["damping_robustness_eps"]]
    assert len(consts) == IDENTITY_BASE
    identity = []
    for p in pols:
        pp = p.params
        if p.accel_metric is v2._velocity_cap_accel_metric:
            region = float(pp["velocity_damping_region"])
            block = (VELCAP, [float(pp["max_velocity"]) - region, region,
                              region - 1e-6, float(pp["metric_weight"]),
                              float(pp["damping_gain"])])
        elif p.accel_metric is v2._joint_damping_accel_metric:
            block = (DAMPING, [float(pp["metric_scalar"]),
                               float(pp["inertia"]),
                               float(pp["accel_d_gain"])])
        elif p.accel_metric is v2._cspace_biasing_accel_metric:
            goal = np.asarray(torch.as_tensor(pp["goal"]).cpu(), np.float32)
            block = (CSPACE, [float(pp["robust_position_term_thresh"]),
                              float(pp["position_gain"]),
                              float(pp["damping_gain"]),
                              float(pp["metric_scalar"])
                              + float(pp["inertia"]), *goal.tolist()])
        else:
            continue
        identity.append((block[0], len(consts)))
        consts += block[1]
    caps = np.array([[*model.collision[f][0].p0, *model.collision[f][0].p1,
                      model.collision[f][0].radius] for f in col_frames],
                    np.float32).reshape(len(col_frames), 7)
    return FusedTick(model=model, ee_frame=att.taskmap.frame_idx,
                     col_frames=col_frames, caps=caps,
                     consts=np.asarray(consts, np.float64).astype(np.float32),
                     identity=tuple(identity))


def _dot3(a, b):
    """a · b over the last axis (3), summed in the JAX body's order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _sum_seq(x):
    """Σ over the last axis, left to right (the JAX body's reduce order)."""
    s = x[..., 0]
    for j in range(1, x.shape[-1]):
        s = s + x[..., j]
    return s


def _sym_lower(C):
    """The lower triangle of C (icol >= jcol) mirrored to the upper one, as
    the JAX body adds each contribution to both entries."""
    low = torch.tril(C)
    return low + torch.tril(C, -1).transpose(-1, -2)


def _add_block(A, cols, C):
    """A[:, cols, cols] += C: the skipped structural zeros stay skipped."""
    ii, jj = cols[:, None], cols[None, :]
    A[:, ii, jj] = A[:, ii, jj] + C


def fused_qdd_plain(tick: FusedTick, q, qd, goal, obs_p0, obs_p1, obs_r):
    """The plain PyTorch version of K5: the JAX kernel body's arithmetic
    (pallas_tick._make_kernel) on batch-first tensors. Divisions by a
    constant divide by a device tensor (a true division, as the kernel's
    and the JAX body's)."""
    model = tick.model
    n = model.n_q
    B = q.shape[0]
    c = [float(v) for v in tick.consts]
    cdev = torch.tensor(tick.consts, device=q.device)

    def div(x, i):
        return x / cdev[i:i + 1]

    def rdiv(i, x):
        return cdev[i:i + 1] / x

    anc = ancestor_table(model)
    fkd = FkDerivatives(model, q, qd)
    T, W, Wd, G = fkd.T, fkd.W, fkd.Wd, fkd.G
    one = torch.ones(B, 1, dtype=q.dtype, device=q.device)

    def point_derivs(f):
        """(p, ṗ, J (B, 3, |cols|) on the ancestor columns, c, cols) of the
        origin of frame f."""
        ph = torch.cat([T[f][:, :3, 3], one], dim=-1)[..., None]   # (B, 4, 1)
        acc = Wd[f] + W[f] @ W[f]
        cols = np.flatnonzero(anc[f] >= 0)
        J = torch.cat([G[anc[f, m]][:, :3] @ ph for m in cols], dim=-1)
        return (ph[:, :3, 0], (W[f][:, :3] @ ph)[..., 0], J,
                (acc[:, :3] @ ph)[..., 0], torch.as_tensor(cols,
                                                           device=q.device))

    A = c[RIDGE] * torch.eye(n, dtype=q.dtype, device=q.device).repeat(B, 1, 1)
    f_sys = torch.zeros(B, n, dtype=q.dtype, device=q.device)

    # attractor on the EE position
    x, xd, Jx, cx, cols = point_derivs(tick.ee_frame)
    delta = goal - x
    dn = torch.sqrt(torch.clamp(_dot3(delta, delta), min=1e-20))
    soft = torch.clamp(dn, min=c[ATT_SOFT])
    dhat = delta / soft[:, None]
    a_att = c[ATT_P] * delta / (dn + c[ATT_EPS])[:, None] - c[ATT_D] * xd
    scaled = div(dn, ATT_ALPHA_LS)
    alpha = c[ATT_ONE_MINUS_MIN_ALPHA] * torch.exp(-0.5 * scaled * scaled) \
        + c[ATT_MIN_ALPHA]
    bs = div(dn, ATT_BOOST_LS)
    boost_a = torch.exp(-0.5 * bs * bs)
    boost = boost_a * c[ATT_BOOST] + (1.0 - boost_a)
    S = ((1.0 - alpha) * c[ATT_MIN_S])[:, None, None] * dhat[:, :, None] \
        * dhat[:, None, :]
    M = boost[:, None, None] * (
        torch.diag_embed((alpha * c[ATT_MAX_S])[:, None].expand(B, 3)) + S)
    u = (M @ (a_att - cx)[..., None])[..., 0]
    f_sys[:, cols] = f_sys[:, cols] + (Jx.transpose(1, 2) @ u[..., None])[..., 0]
    _add_block(A, cols, _sym_lower(Jx.transpose(1, 2) @ (M @ Jx)))

    # identity-space leaves, in policy order
    for kind, o in tick.identity:
        if kind == VELCAP:
            cutoff, wgt, gain = c[o], c[o + 3], c[o + 4]
            dv = qd.abs() - cutoff
            a = -(gain * dv).abs() * torch.sign(qd)
            a = torch.where(qd.abs() < cutoff, torch.zeros_like(a), a)
            ratio = div(torch.clamp(dv, max=c[o + 2]), o + 1)
            m = rdiv(o + 3, 1.0 - ratio * ratio)
            f_sys = f_sys + (wgt * _sum_seq(a)[:, None] + (m - wgt) * a)
            A = (A + torch.diag_embed(m - wgt)) + wgt
        elif kind == DAMPING:
            xdn = torch.sqrt(torch.clamp(_sum_seq(qd * qd), min=1e-20))
            e = c[o] * xdn + c[o + 1]
            f_sys = f_sys + e[:, None] * ((-c[o + 2] * xdn)[:, None] * qd)
            A = A + torch.diag_embed(e[:, None].expand(B, n))
        else:   # CSPACE
            thresh, pg, dg, e = c[o:o + 4]
            xs = q - cdev[o + 4:o + 4 + n]
            xn = torch.sqrt(torch.clamp(_sum_seq(xs * xs), min=1e-24))
            xhat = xs / torch.clamp(xn, min=1e-12)[:, None]
            a_pos = torch.where((xn < thresh)[:, None], -xs * pg,
                                -thresh * xhat * pg)
            f_sys = f_sys + e * (a_pos - dg * qd)
            A = A + e * torch.eye(n, dtype=q.dtype, device=q.device)

    # grouped obstacle avoidance: first capsule of each collision frame
    K = obs_p0.shape[1]
    for li, fr in enumerate(tick.col_frames):
        _, pd, Jo, co, cols = point_derivs(fr)
        Tf = T[fr]
        cap = tick.caps[li]

        def transform(p):
            return (Tf[:, :3, 0] * float(p[0]) + Tf[:, :3, 1] * float(p[1])
                    + Tf[:, :3, 2] * float(p[2]) + Tf[:, :3, 3])

        a0 = transform(cap[0:3])[:, None].expand(B, K, 3)
        a1 = transform(cap[3:6])[:, None].expand(B, K, 3)
        s, t = segment_closest_params(a0, a1, obs_p0, obs_p1)
        ca = a0 + s[..., None] * (a1 - a0)
        cb = obs_p0 + t[..., None] * (obs_p1 - obs_p0)
        diff = ca - cb
        cdist = torch.sqrt(torch.clamp(_dot3(diff, diff), min=1e-18))
        nvec = diff / cdist[..., None]
        h = (ca - float(cap[6]) * nvec) - (cb + obs_r[..., None] * nvec)
        d_c = torch.sqrt(torch.clamp(_dot3(h, h), min=1e-18))
        nh = h / d_c[..., None]                                  # (B, K, 3)
        Jd = (nh[..., 0:1] * Jo[:, None, 0] + nh[..., 1:2] * Jo[:, None, 1]
              + nh[..., 2:3] * Jo[:, None, 2])                  # (B, K, |cols|)
        xd_d = _dot3(nh, pd[:, None])
        c_d = _dot3(nh, co[:, None]) \
            + (_dot3(pd, pd)[:, None] - xd_d * xd_d) / d_c
        xdist = torch.clamp(d_c - c[OBS_MARGIN], min=0.0)
        far = xdist > c[OBS_RMOD]
        gate = div(xdist * xdist, OBS_RMOD_SQ) - div(2.0 * xdist, OBS_RMOD) \
            + 1.0
        gate = torch.where(far, torch.zeros_like(gate), gate)
        metric = rdiv(OBS_METRIC, div(xdist, OBS_EXPLODER_STD)
                      + c[OBS_EXPLODER_EPS]) * gate
        a_rep = c[OBS_REP_GAIN] * torch.exp(div(-xdist, OBS_REP_STD))
        sig = torch.sigmoid(div(xd_d, OBS_GATE_LS))
        a_damp = -(1.0 - sig) * c[OBS_DAMP_GAIN] * xd_d / (
            div(xdist, OBS_DAMP_STD) + c[OBS_ROBUST_EPS])
        metric = torch.where(far, torch.zeros_like(metric),
                             (1.0 - sig) * metric)
        amc = a_rep + a_damp - c_d
        mj = metric[..., None] * Jd
        for k in range(K):
            f_sys[:, cols] = f_sys[:, cols] \
                + Jd[:, k] * metric[:, k, None] * amc[:, k, None]
            _add_block(A, cols, _sym_lower(Jd[:, k, :, None]
                                           * mj[:, k, None, :]))

    # A is built with the ridge on its diagonal: the solve adds none
    return cholesky_solve_unrolled(A, f_sys, ridge=0.0)


def _check(n: int, q, qd, goal, obs_p0, obs_p1, obs_r):
    args = dict(q=q, qd=qd, goal=goal, obs_p0=obs_p0, obs_p1=obs_p1,
                obs_r=obs_r)
    for name, t in args.items():
        if t.dtype != torch.float32:
            raise TypeError(f"fused_qdd takes float32, got {name} {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device} but q on {q.device}")
    B, K = q.shape[0], obs_r.shape[-1]
    want = dict(q=(B, n), qd=(B, n), goal=(B, 3), obs_p0=(B, K, 3),
                obs_p1=(B, K, 3), obs_r=(B, K))
    for name, shape in want.items():
        if tuple(args[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(args[name].shape)}")


def fused_qdd(tick: FusedTick, q, qd, goal, obs_p0, obs_p1, obs_r):
    """q̈ (B, n) of the fused tick for float32 batch-first inputs."""
    model = tick.model
    n = model.n_q
    _check(n, q, qd, goal, obs_p0, obs_p1, obs_r)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, qd, goal, obs_p0, obs_p1, obs_r)):
        raise RuntimeError("K5 (fused_qdd) has no derivative rule: call it "
                           "under torch.no_grad() or on inputs that do not "
                           "require grad")
    if q.device.type == "cpu":
        return fused_qdd_plain(tick, q, qd, goal, obs_p0, obs_p1, obs_r)
    if q.device.type != "cuda":
        raise ValueError(f"no K5 kernel for device {q.device}")
    args = (q, qd, goal, obs_p0, obs_p1, obs_r)
    if not all(t.is_contiguous() for t in args):
        raise ValueError("fused_qdd inputs must be contiguous")

    B, K = q.shape[0], obs_r.shape[1]
    mt = model_tables(model, q.device)
    tt = tick.tables(q.device)
    out = torch.empty(B, n, dtype=torch.float32, device=q.device)
    fn = _build.c_function("rmp_fused_qdd_f32", _ARGTYPES)
    rc = fn(q.device.index, B, model.n_frames, n, K, len(tick.col_frames),
            tick.ee_frame, len(tick.identity), mt["parent"].data_ptr(),
            mt["joint_type"].data_ptr(), mt["q_index"].data_ptr(),
            mt["axis"].data_ptr(), mt["T_constant"].data_ptr(),
            mt["anc"].data_ptr(), tt["col_frames"].data_ptr(),
            tt["caps"].data_ptr(), tt["identity"].data_ptr(),
            tt["consts"].data_ptr(), *(t.data_ptr() for t in args),
            out.data_ptr(), _build.raw_stream(q.device))
    if rc == -1:
        raise ValueError(f"model {model.name!r} ({model.n_frames} frames, "
                         f"{n} motors, {len(tick.col_frames)} collision "
                         f"frames) exceeds the K5 kernel's capacity")
    if rc != 0:
        raise RuntimeError(f"K5 fused_qdd launch failed: CUDA error {rc}")
    fused_qdd.launches += 1
    return out


fused_qdd.launches = 0


def make_fused_qdd(env, ridge: float = 1e-6):
    """fn(q, qd, goal, obs_p0, obs_p1, obs_r) -> q̈ (B, n) for `env`, the
    port of pallas_tick.make_fused_qdd (JAX's needs B % 1024 == 0; this one
    takes any B). Raises on an env that `supports` rejects."""
    return functools.partial(fused_qdd, fused_tick(env, ridge))


def standard_qdd(env, q, qd, goal, obs_p0, obs_p1, obs_r,
                 first_capsule: bool = True):
    """The standard q̈ (evaluate_policies, 'cholesky', analytic FK) of `env`
    at K5's inputs, on a copy of the model whose links keep their first
    capsule (what K5 computes) or on the full model."""
    model = env.model
    if first_capsule:
        model = dataclasses.replace(model, collision=tuple(
            c[:1] for c in model.collision))
    sim = SimState(q=q, qd=qd, t=torch.zeros_like(q[:, 0]),
                   obstacles=ObstacleSet(obs_p0, obs_p1, obs_r), goal=goal)
    params = env.bind_params(env.gather_params(), sim, env.policies)
    _, _, ctx = sense(model, sim)
    ctxs = tuple(ctx.get(p.ctx_key) if p.ctx_key else None
                 for p in env.policies)
    return evaluate_policies(env.policies, q, qd, params, ctxs,
                             method="cholesky")
