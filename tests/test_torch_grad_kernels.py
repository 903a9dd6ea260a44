"""Gradients through the port's kernel wrappers on the CPU, against the JAX
package's derivatives of the same functions on the same numpy inputs.

- K1 (and K2a/K2b on its kernel): `cuda_resolve.PullbackResolve`'s
  closed-form backward against `jax.vjp` of JAX's assembly plus its
  unrolled LU (`rmp_tpu.ops.linalg.lu_solve_unrolled`), at n = 2, 6, 9 and
  18, on random blocks in scene 06's layout and on one real scene-06 tick.
- K3: `cuda_fk.FkDerivatives`' backward (the recomputed plain vjp) against
  `jax.vjp` of `rmp_tpu.models.fk_derivatives` on the Panda and the UR5,
  cotangents on a subset of the outputs too.
- K4: `cuda_gjk.GjkHullObstacles`' backward against JAX's `_gjk_bwd` on the
  same residuals and cotangents, and JAX's per-env finite-difference check
  of the batched hull query (tests/test_pallas_gjk.py).
- `support_hull`: autograd is the envelope rule (tests/test_gjk.py's
  finite differences and contact normal; ∂s/∂d = 0, ∂s/∂verts the
  selection).
- Each wrapper's Function is the route on the CPU while an input requires
  grad, and K5 raises under grad.

Tolerances are stated where used, each with the agreement measured on the
CPU host when it was set.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu.models import fk_derivatives as jfkd
from rmp_tpu.models import robots as jrobots
from rmp_tpu.ops import gjk as jgjk
from rmp_tpu.ops import linalg as jlinalg
from rmp_tpu.ops import pallas_gjk as jpg
from rmp_tpu_torch import envs
from rmp_tpu_torch.core import policy_row_blocks_structured
from rmp_tpu_torch.envs.base import _policy_inputs
from rmp_tpu_torch.models import kinematics as K
from rmp_tpu_torch.models import robots
from rmp_tpu_torch.models.hulls import hulls_for
from rmp_tpu_torch.ops import cuda_fk, cuda_gjk, cuda_resolve, cuda_tick, gjk
from rmp_tpu_torch.sim import collision as C
from rmp_tpu_torch.sim import randomizer as rnd
from test_torch_gjk import KERNEL_ARGS, kernel_operands

torch.set_num_threads(1)

SCENE06 = (("dense", 3), ("identity", 0), ("identity", 0), ("identity", 0),
           ("scalar", 70))


def layout_blocks(seed: int, B: int, n: int, layout):
    """numpy blocks of `layout`: dense W = S J (S SPD), SPD identity
    metrics, non-negative scalar metrics."""
    rng = np.random.default_rng(seed)

    def spd(d):
        L = rng.normal(size=(B, d, d)) * 0.3
        return L @ L.transpose(0, 2, 1) + 0.5 * np.eye(d)

    blocks = []
    for tag, R in layout:
        if tag == "identity":
            blk = (spd(n), rng.normal(size=(B, n)))
        elif tag == "dense":
            J = rng.normal(size=(B, R, n))
            blk = (J, spd(R) @ J, rng.normal(size=(B, R)))
        else:
            blk = (rng.normal(size=(B, R, n)) * 0.3,
                   rng.uniform(0.0, 2.0, (B, R)), rng.normal(size=(B, R)))
        blocks.append(tuple(np.asarray(x, np.float32) for x in blk))
    return tuple(tag for tag, _ in layout), blocks


def jax_resolve(tags, ridge):
    """x = (A + ridge I)⁻¹ f of flat block arrays, JAX's einsum assembly
    (envs/base.py's batched step) and its unrolled LU."""
    def fn(*flat):
        A = f = 0.0
        at = 0
        for tag in tags:
            if tag == "identity":
                M, v = flat[at:at + 2]
                at += 2
                A, f = A + M, f + v
                continue
            J, X, v = flat[at:at + 3]
            at += 3
            if tag == "scalar":
                A = A + jnp.einsum("brn,br,brm->bnm", J, X, J)
            else:
                A = A + jnp.einsum("brn,brm->bnm", J, X)
            f = f + jnp.einsum("brn,br->bn", J, v)
        n = A.shape[-1]
        return jlinalg.lu_solve_unrolled(A + ridge * jnp.eye(n), f)
    return fn


def port_resolve_grads(tags, blocks, xbar, ridge):
    """(x, the flat block cotangents) through the port's wrapper."""
    leaves = [tuple(torch.tensor(x, requires_grad=True) for x in blk)
              for blk in blocks]
    x = cuda_resolve.pullback_resolve_structured(tags, leaves, ridge=ridge)
    assert type(x.grad_fn).__name__ == "PullbackResolveBackward"
    flat = [t for blk in leaves for t in blk]
    grads = torch.autograd.grad(x, flat, torch.tensor(xbar))
    return x.detach().numpy(), [g.numpy() for g in grads]


def assert_cotangents_close(got, want, rtol):
    """Each cotangent within rtol x the largest |entry| of JAX's."""
    for k, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.shape == w.shape, k
        scale = max(1.0, float(np.abs(w).max()))
        err = float(np.abs(g - w).max())
        assert err <= rtol * scale, (k, err, scale)


# Agreement measured on the CPU host: at most 3.0e-7 x max(1, max|cotangent|)
# on these blocks at every n and ridge, 2.5e-7 on the real tick (the closed
# form and JAX's autodiff through the same LU round apart); held to 1e-4,
# the class of the forward's own tolerance (2e-4 x max(1, |q̈|)).
K1_RTOL = 1e-4


@pytest.mark.parametrize("ridge", [0.0, 1e-6])
@pytest.mark.parametrize("n", [2, 6, 9, 18])
def test_k1_backward_matches_jax_vjp(n, ridge):
    tags, blocks = layout_blocks(n, 32, n, SCENE06)
    xbar = np.random.default_rng(100 + n).normal(size=(32, n)) \
        .astype(np.float32)
    flat = [jnp.asarray(x) for blk in blocks for x in blk]
    want_x, vjp = jax.vjp(jax_resolve(tags, ridge), *flat)
    want = vjp(jnp.asarray(xbar))
    x, got = port_resolve_grads(tags, blocks, xbar, ridge)
    np.testing.assert_allclose(x, np.asarray(want_x), atol=2e-4)
    assert_cotangents_close(got, want, K1_RTOL)


def scene06_tick_blocks(B=16, seed=1):
    """One real franka/06 tick's blocks on the CPU, from reset states
    moved by q ± 0.05, q̇ ± 0.05, as float32 numpy."""
    env = envs.make("franka/06_cluttered_environment", device="cpu")
    rng = np.random.default_rng(seed)
    states = envs.make_batched_reset(env, B)()
    move = [torch.tensor(rng.uniform(-0.05, 0.05, (B, 9)),
                         dtype=torch.float32) for _ in range(2)]
    states = dataclasses.replace(states, sim=dataclasses.replace(
        states.sim, q=states.sim.q + move[0], qd=move[1]))
    q, qd, params, ctxs, fk = _policy_inputs(env, states, env.gather_params())
    tags, blocks = policy_row_blocks_structured(env.policies, q, qd, params,
                                                ctxs, fk=fk)
    return tags, [tuple(np.ascontiguousarray(x.numpy()) for x in blk)
                  for blk in blocks]


def test_k1_backward_matches_jax_vjp_on_a_real_scene06_tick():
    tags, blocks = scene06_tick_blocks()
    assert tags == tuple(t for t, _ in SCENE06)
    xbar = np.random.default_rng(7).normal(size=(16, 9)).astype(np.float32)
    flat = [jnp.asarray(x) for blk in blocks for x in blk]
    _, vjp = jax.vjp(jax_resolve(tags, 0.0), *flat)
    _, got = port_resolve_grads(tags, blocks, xbar, 0.0)
    assert_cotangents_close(got, vjp(jnp.asarray(xbar)), K1_RTOL)


def test_k1_backward_screens_the_pivot_clamp():
    """The closed form differs from autograd through the plain LU only
    where the sign-preserving pivot clamp (|pivot| < 1e-12) is active: on
    these blocks no pivot comes near it (the least |pivot| is printed by
    the assertion), and the two agree to K1_RTOL."""
    tags, blocks = layout_blocks(3, 32, 9, SCENE06)
    tblocks = [tuple(torch.tensor(x, dtype=torch.float64) for x in blk)
               for blk in blocks]
    A, _ = cuda_resolve.assemble_structured(tags, tblocks)
    pivots = torch.linalg.lu_factor(A)[0].diagonal(dim1=-2, dim2=-1)
    assert float(pivots.abs().min()) > 1e-3, float(pivots.abs().min())
    xbar = np.random.default_rng(8).normal(size=(32, 9)).astype(np.float32)
    _, got = port_resolve_grads(tags, blocks, xbar, 0.0)
    leaves = [tuple(torch.tensor(x, requires_grad=True) for x in blk)
              for blk in blocks]
    x = cuda_resolve.pullback_resolve_structured_plain(tags, leaves)
    want = torch.autograd.grad(x, [t for b in leaves for t in b],
                               torch.tensor(xbar))
    assert_cotangents_close(got, [w.numpy() for w in want], K1_RTOL)


def test_k2_entry_points_take_the_function():
    """K2a (both layouts) and K2b run PullbackResolve under grad, and their
    cotangents equal JAX's vjp of the dense system."""
    tags, blocks = layout_blocks(5, 8, 9, (("dense", 30),))
    J, W, v = (torch.tensor(x, requires_grad=True) for x in blocks[0])
    xbar = torch.tensor(np.random.default_rng(9).normal(size=(8, 9)),
                        dtype=torch.float32)
    _, vjp = jax.vjp(jax_resolve(tags, 1e-6),
                     *(jnp.asarray(x) for x in blocks[0]))
    want = vjp(jnp.asarray(xbar.numpy()))
    outs = [cuda_resolve.pullback_resolve(J, W, v),
            cuda_resolve.pullback_resolve_t(J.permute(2, 1, 0),
                                            W.permute(2, 1, 0),
                                            v.permute(1, 0)),
            cuda_resolve.pullback_resolve_blocks([J], [W], [v], ridge=1e-6)]
    for x in outs:
        assert type(x.grad_fn).__name__ == "PullbackResolveBackward"
        got = torch.autograd.grad(x, (J, W, v), xbar)
        assert_cotangents_close([g.numpy() for g in got], want, K1_RTOL)


K3_MODELS = {"panda": (robots.franka_panda, jrobots.franka_panda),
             "ur5": (robots.ur5, jrobots.ur5)}


@pytest.mark.parametrize("outputs", [(0, 1, 2, 3), (2,), (0, 3)])
@pytest.mark.parametrize("name", sorted(K3_MODELS))
def test_k3_backward_matches_jax_vjp(name, outputs):
    """Cotangents on the outputs listed (None on the others). Agreement
    measured: 3.0e-7 (Panda) and 1.8e-7 (UR5) x max(1, max|cotangent|)
    with cotangents on all four; held to 1e-4 (float32 vjps of the same
    closed form, summed in other orders)."""
    model, jmodel = (f() for f in K3_MODELS[name])
    rng = np.random.default_rng(11)
    B, n, F = 16, model.n_q, model.n_frames
    q = rng.uniform(-1.2, 1.2, (B, n)).astype(np.float32)
    qd = rng.uniform(-1.0, 1.0, (B, n)).astype(np.float32)
    shapes = ((B, F, 16), (B, F, 16), (B, F, 16, n), (B, F, 16))
    cts = [rng.normal(size=s).astype(np.float32) if i in outputs
           else np.zeros(s, np.float32) for i, s in enumerate(shapes)]
    fn = jax.vmap(lambda a, b: jfkd.fk_derivatives(jmodel, a, b))
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(qd))
    want = vjp(tuple(jnp.asarray(c) for c in cts))
    tq = torch.tensor(q, requires_grad=True)
    tqd = torch.tensor(qd, requires_grad=True)
    before = cuda_fk.fk_derivatives_batched.launches
    outs = cuda_fk.fk_derivatives_batched(model, tq, tqd)
    assert all(type(o.grad_fn).__name__ == "FkDerivativesBackward"
               for o in outs)
    got = torch.autograd.grad([outs[i] for i in outputs], (tq, tqd),
                              [torch.tensor(cts[i]) for i in outputs],
                              allow_unused=True)
    assert cuda_fk.fk_derivatives_batched.launches == before
    # J16 alone does not depend on q̇: its cotangent is None (zero)
    got = [np.zeros(x.shape, np.float32) if g is None else g.numpy()
           for g, x in zip(got, (q, qd))]
    assert_cotangents_close(got, want, 1e-4)


def test_k3_backward_wrt_q_alone():
    """A q̇ that needs no grad gets none; q's cotangent is unchanged."""
    model = robots.franka_panda()
    rng = np.random.default_rng(12)
    q = torch.tensor(rng.uniform(-1, 1, (4, 9)), dtype=torch.float32,
                     requires_grad=True)
    qd = torch.tensor(rng.uniform(-1, 1, (4, 9)), dtype=torch.float32)
    T16, _, J16, _ = cuda_fk.fk_derivatives_batched(model, q, qd)
    g = torch.autograd.grad((T16.sum() + J16.sum()), q)[0]
    qq = q.detach().requires_grad_()
    T_ref, _, J_ref, _ = cuda_fk.fk_derivatives(model, qq, qd)
    want = torch.autograd.grad((T_ref.sum() + J_ref.sum()), qq)[0]
    torch.testing.assert_close(g, want, rtol=0, atol=0)


def k4_residuals(seed=3):
    """Panda-table K4 operands and cotangents, with the port's forward."""
    ops = kernel_operands(hulls_for(robots.franka_panda())[:4], seed, B=16)
    args = [torch.tensor(ops[k]) for k in KERNEL_ARGS]
    pa, pb, dist = cuda_gjk.gjk_hull_obstacles(*args)
    rng = np.random.default_rng(seed)
    cts = [rng.normal(size=tuple(x.shape)).astype(np.float32)
           for x in (pa, pb, dist)]
    return ops, args, (pa, pb, dist), cts


def test_k4_backward_is_jax_gjk_bwd_on_the_same_residuals():
    """The port's rule against JAX's `_gjk_bwd` on identical residuals
    (the port's forward outputs) and cotangents. Agreement measured:
    9.5e-7 absolute (the same arithmetic, its einsums summed in other
    orders); held to 1e-5."""
    ops, args, outs, cts = k4_residuals()
    res = tuple(jnp.asarray(ops[k]) for k in KERNEL_ARGS) + tuple(
        jnp.asarray(x.numpy()) for x in outs)
    want = jpg._gjk_bwd(10, False, False, 32, res,
                        tuple(jnp.asarray(c) for c in cts))
    leaves = [a.clone().requires_grad_() for a in args]
    pa, pb, dist = cuda_gjk.gjk_hull_obstacles(*leaves)
    assert type(dist.grad_fn).__name__ == "GjkHullObstaclesBackward"
    for o, x in zip((pa, pb, dist), outs):
        torch.testing.assert_close(o.detach(), x, rtol=0, atol=0)
    got = torch.autograd.grad((pa, pb, dist), leaves,
                              [torch.tensor(c) for c in cts],
                              allow_unused=True)
    for name, g, w in zip(KERNEL_ARGS, got, want):
        w = np.asarray(w)
        if name in ("verts", "an", "is_cyl", "d0"):
            assert g is None and not w.any(), name
            continue
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, err_msg=name)


def test_k4_backward_with_cotangents_on_dist_alone():
    ops, args, outs, cts = k4_residuals(seed=4)
    leaves = [a.clone().requires_grad_() for a in args]
    dist = cuda_gjk.gjk_hull_obstacles(*leaves)[2]
    got = torch.autograd.grad(dist, leaves, torch.tensor(cts[2]),
                              allow_unused=True)
    res = tuple(jnp.asarray(ops[k]) for k in KERNEL_ARGS) + tuple(
        jnp.asarray(x.numpy()) for x in outs)
    zeros = tuple(jnp.zeros_like(jnp.asarray(x.numpy())) for x in outs[:2])
    want = jpg._gjk_bwd(10, False, False, 32, res,
                        zeros + (jnp.asarray(cts[2]),))
    for name, g, w in zip(KERNEL_ARGS, got, want):
        if g is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       err_msg=name)


def test_hull_query_gradient_matches_finite_differences():
    """JAX's per-env check of the batched hull query's gradient
    (tests/test_pallas_gjk.py): a smooth loss over the distances of pairs
    farther than 5 mm, its gradient in q through K3's and K4's Functions
    against central differences of each env's own term (h = 3e-3), within
    8% + 1e-3 on at least 3 non-flat coordinates."""
    model = robots.franka_panda()
    g = torch.Generator().manual_seed(0)
    B = 16
    qs = rnd.randomize_robot_config(g, B)[0]
    obs = rnd.randomize_obstacles(g, B, 4)
    K_obs = obs.count
    d0 = C.robot_obstacle_distances_hull_batched(
        model, K.fk_all(model, qs), obs, top_m=K_obs)[3]
    mask = (d0 > 5e-3).to(torch.float32)

    def loss_env(q_b, env_mask):
        T = K.fk_all(model, q_b)
        d = C.robot_obstacle_distances_hull_batched(model, T, obs,
                                                    top_m=K_obs)[3]
        return torch.sum(torch.exp(-4.0 * d) * mask * env_mask)

    q = qs.clone().requires_grad_()
    grad = torch.autograd.grad(loss_env(q, torch.ones_like(mask)), q)[0]
    rng = np.random.default_rng(1)
    h, checked = 3e-3, 0
    for _ in range(8):
        b, j = int(rng.integers(0, B)), int(rng.integers(0, 7))
        e = torch.zeros_like(qs)
        e[b, j] = h
        em = torch.zeros_like(mask)
        em[b] = 1.0
        with torch.no_grad():
            fd = (float(loss_env(qs + e, em))
                  - float(loss_env(qs - e, em))) / (2 * h)
        an = float(grad[b, j])
        if abs(fd) < 1e-3:
            continue            # flat coordinate: finite-difference noise
        assert abs(an - fd) < 0.08 * abs(fd) + 1e-3, (b, j, an, fd)
        checked += 1
    assert checked >= 3


CUBE = torch.tensor([[sx, sy, sz] for sx in (-0.5, 0.5) for sy in (-0.5, 0.5)
                     for sz in (-0.5, 0.5)], dtype=torch.float32)


def test_support_hull_gradient_matches_finite_differences():
    """tests/test_gjk.py's check on the port: the GJK distance of a cube
    translated by t against a sphere, its autograd gradient in t (through
    support_hull's selection, no Function) equal to central differences
    and to the contact normal within 2e-3."""
    centers = torch.tensor([[2.0, 0.7, 0.4], [1.3, 1.6, -0.9],
                            [-1.8, 1.1, 0.6]])
    r = torch.tensor(0.25)

    def dist_of(t, c):
        return gjk.closest_points(
            lambda d: gjk.support_hull(CUBE + t, d),
            lambda d: gjk.support_sphere(c, r, d), c - t, iters=32)[3]

    for c in centers:
        t0 = torch.zeros(3, requires_grad=True)
        grad = torch.autograd.grad(dist_of(t0, c), t0)[0]
        h = 1e-3
        fd = torch.zeros(3)
        for k in range(3):
            e = torch.zeros(3)
            e[k] = h
            fd[k] = (dist_of(e, c) - dist_of(-e, c)) / (2 * h)
        torch.testing.assert_close(grad, fd, rtol=0, atol=2e-3)
        n = gjk.closest_points(lambda d: gjk.support_hull(CUBE, d),
                               lambda d: gjk.support_sphere(c, r, d), c,
                               iters=32)[2]
        torch.testing.assert_close(grad, n, rtol=0, atol=2e-3)


def test_support_hull_autograd_is_the_envelope_rule():
    """∂s/∂d = 0 (the selection is made by comparisons) and ∂s/∂verts is
    the selection: the first maximiser for support_hull, the tie average
    for K4's support_hull_avg, equal to the JAX rule's tangent."""
    d = torch.tensor([1.0, 0.0, 0.0], requires_grad=True)
    for fn in (gjk.support_hull, gjk.support_hull_avg):
        assert not fn(CUBE, d).requires_grad
    tangent = torch.arange(24, dtype=torch.float32).reshape(8, 3) / 10
    _, first = torch.func.jvp(lambda v: gjk.support_hull(v, d.detach()),
                              (CUBE,), (tangent,))
    _, avg = torch.func.jvp(lambda v: gjk.support_hull_avg(v, d.detach()),
                            (CUBE,), (tangent,))
    tied = CUBE[:, 0] == 0.5                        # four vertices tie on +x
    torch.testing.assert_close(first, tangent[tied][0], rtol=0, atol=0)
    torch.testing.assert_close(avg, tangent[tied].mean(0), rtol=0, atol=1e-7)
    ones = jax.jvp(lambda v: jgjk.support_hull(v, jnp.asarray([1., 0, 0])),
                   (jnp.asarray(CUBE.numpy()),),
                   (jnp.ones((8, 3), jnp.float32),))[1]
    _, mine = torch.func.jvp(lambda v: gjk.support_hull_avg(v, d.detach()),
                             (CUBE,), (torch.ones(8, 3),))
    np.testing.assert_allclose(mine.numpy(), np.asarray(ones), atol=1e-6)


def test_wrappers_route_through_their_functions_only_under_grad():
    """Without grad each wrapper returns plain outputs (no Function);
    with an input that requires grad, its Function's backward node."""
    model = robots.two_joint_robot()
    q = torch.zeros(2, 2)
    assert cuda_fk.fk_derivatives_batched(model, q, q)[0].grad_fn is None
    with torch.no_grad():
        out = cuda_fk.fk_derivatives_batched(model, q.requires_grad_(), q)
    assert out[0].grad_fn is None
    tags, blocks = layout_blocks(1, 4, 9, SCENE06)
    tb = [tuple(torch.tensor(x) for x in blk) for blk in blocks]
    assert cuda_resolve.pullback_resolve_structured(tags, tb).grad_fn is None
    tb[1] = (tb[1][0].requires_grad_(), tb[1][1])
    x = cuda_resolve.pullback_resolve_structured(tags, tb)
    assert type(x.grad_fn).__name__ == "PullbackResolveBackward"
    ops, args, _, _ = k4_residuals()
    assert cuda_gjk.gjk_hull_obstacles(*args)[2].grad_fn is None
    args[3].requires_grad_()
    out = cuda_gjk.gjk_hull_obstacles(*args)
    assert type(out[2].grad_fn).__name__ == "GjkHullObstaclesBackward"


def test_k5_raises_under_grad():
    """K5 has no derivative rule (JAX's pallas_call has none either): it
    raises while grad is enabled and an input requires grad, and runs
    under torch.no_grad()."""
    env = envs.make("franka/06_cluttered_environment", device="cpu")
    fn = cuda_tick.make_fused_qdd(env)
    states = envs.make_batched_reset(env, 2)()
    obs = states.sim.obstacles
    q = states.sim.q.clone().requires_grad_()
    args = (states.sim.qd, states.sim.goal, obs.p0, obs.p1, obs.radius)
    with pytest.raises(RuntimeError, match="no derivative rule"):
        fn(q, *args)
    with torch.no_grad():
        assert torch.isfinite(fn(q, *args)).all()
