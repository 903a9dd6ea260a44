"""The port's v1 policies, their metric helpers, the relative-point taskmap
and the plain FK-derivative kernel (K3) on the two-joint robot and the UR5,
against the JAX package on the same seeded numpy inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu import core as jcore
from rmp_tpu import envs as jenvs
from rmp_tpu.envs import base as jbase
from rmp_tpu.models import fk_derivatives as jfkd
from rmp_tpu.models import robots as jrobots
from rmp_tpu.ops import metrics as jmetrics
from rmp_tpu.policies import v1 as jv1
from rmp_tpu_torch import convert, envs
from rmp_tpu_torch.core import _taskmap_derivatives_analytic
from rmp_tpu_torch.envs.base import _policy_inputs
from rmp_tpu_torch.models import fk_derivatives as fkd
from rmp_tpu_torch.models import robots
from rmp_tpu_torch.ops import cuda_fk, metrics
from rmp_tpu_torch.policies import v1
from test_torch_kinematics import replay_k3_stores
from test_torch_scenes import jax_state_leaves

torch.set_num_threads(1)

B, P = 16, 5
RTOL = 1e-6          # as tests/test_torch_conditioning.py holds the v2 leaves
REL = 1e-4           # taskmap derivatives, as tests/test_torch_core.py
K3_ATOL = 2e-4       # the tolerance of tests/test_pallas_fk.py


def assert_leaf_close(got, want, what):
    """rtol RTOL, and RTOL of the largest |entry| for entries near 0."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=RTOL * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


def jax_leaf(fn, params, *args):
    """A JAX leaf over the batch, its scalar params traced as float32 (as
    the JAX rollout traces them)."""
    return jax.jit(jax.vmap(fn, in_axes=(None,) + (0,) * len(args)))(
        jax.tree.map(jnp.float32, params), *(jax.tree.map(jnp.asarray, a)
                                             for a in args))


def test_metric_helpers_match_jax():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(B, P, 3)).astype(np.float32)
    v[0] = 0.0                                      # the soft norm at v = 0
    beta = rng.uniform(0, 1, (B, P)).astype(np.float32)
    d = rng.uniform(-0.2, 1.5, (B, P)).astype(np.float32)
    cases = [
        (metrics.soft_norm(torch.tensor(v), 0.7),
         jmetrics.soft_norm(jnp.asarray(v), 0.7), "soft_norm"),
        (metrics.directionally_stretched_metric(torch.tensor(v),
                                                torch.tensor(beta), 5.0),
         jmetrics.directionally_stretched_metric(jnp.asarray(v),
                                                 jnp.asarray(beta), 5.0),
         "stretched, per-row beta"),
        (metrics.directionally_stretched_metric(torch.tensor(v), 0.9, 5.0),
         jmetrics.directionally_stretched_metric(jnp.asarray(v), 0.9, 5.0),
         "stretched, scalar beta"),
        (metrics.cubic_spline_weight(torch.tensor(d), 1.1),
         jmetrics.cubic_spline_weight(jnp.asarray(d), 1.1), "spline"),
    ]
    for got, want, what in cases:
        assert_leaf_close(got, want, what)


def _x(rng, d, scale=1.0):
    return (rng.normal(size=(B, P, d)) * scale).astype(np.float32)


@pytest.mark.parametrize("per_env_goal", [False, True])
def test_target_policy_matches_jax(per_env_goal):
    """A goal shared by the batch (3,) or one per env (B, 3); one row sits
    on its goal (z = 0)."""
    rng = np.random.default_rng(1)
    x, xd = _x(rng, 3), _x(rng, 3, 0.3)
    goals = rng.normal(size=(B, 3)).astype(np.float32)
    if not per_env_goal:
        goals[:] = goals[0]
    x[0, 0] = goals[0]
    pol = v1.target_policy(goal=goals[0], taskmap=None, alpha=0.3, beta=0.5,
                           c=0.1)
    prm = dict(pol.params,
               goal=torch.tensor(goals if per_env_goal else goals[0]))
    a, M = pol.accel_metric(prm, torch.tensor(x), torch.tensor(xd), None)
    jprm = jax.tree.map(jnp.float32, {
        k: v for k, v in jv1.target_policy(goal=goals[0], taskmap=None,
                                           alpha=0.3, beta=0.5,
                                           c=0.1).params.items()
        if k != "goal"})
    want = jax.jit(jax.vmap(lambda g, a_, b_: jv1._target_accel_metric(
        dict(jprm, goal=g), a_, b_, None)))(
        jnp.asarray(goals), jnp.asarray(x), jnp.asarray(xd))
    assert_leaf_close(a, want[0], "a")
    assert_leaf_close(M, want[1], "M")


@pytest.mark.parametrize("masked", [False, True])
def test_collision_avoidance_matches_jax(masked):
    """Distances on both sides of r (the spline's cut), normals of unit
    length, and, masked, half the pairs switched off."""
    rng = np.random.default_rng(2)
    x, xd = _x(rng, 3), _x(rng, 3, 0.5)
    normal = rng.normal(size=(B, P, 3))
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    ctx = dict(distance=rng.uniform(0.0, 1.5, (B, P)),
               normal=normal)
    if masked:
        ctx["mask"] = (rng.uniform(size=(B, P)) < 0.5)
    ctx = {k: np.asarray(v, np.float32) for k, v in ctx.items()}
    pol = v1.collision_avoidance(None, eta_rep=0.1 * np.e, nu_rep=0.3,
                                 eta_damp=1.0, nu_damp=0.3, r=1.1, c=1e5)
    a, M = pol.accel_metric(pol.params, torch.tensor(x), torch.tensor(xd),
                            {k: torch.tensor(v) for k, v in ctx.items()})
    want = jax_leaf(jv1._collision_accel_metric, pol.params, x, xd, ctx)
    assert_leaf_close(a, want[0], "a")
    assert_leaf_close(M, want[1], "M")


def test_configuration_space_biasing_matches_jax():
    rng = np.random.default_rng(3)
    x, xd = _x(rng, 2), _x(rng, 2, 0.3)
    pol = v1.configuration_space_biasing([np.pi / 2, 0.0], gamma_p=0.01,
                                         gamma_d=0.1, name="bias")
    a, M = pol.accel_metric(pol.params, torch.tensor(x), torch.tensor(xd),
                            None)
    jpol = jv1.configuration_space_biasing([np.pi / 2, 0.0], gamma_p=0.01,
                                           gamma_d=0.1, name="bias")
    want = jax_leaf(lambda p, a_, b_: jpol.accel_metric(p, a_, b_, None),
                    jpol.params, x, xd)
    assert_leaf_close(a, want[0], "a")
    assert_leaf_close(M, want[1], "M")


def test_joint_limit_avoidance_matches_jax_and_is_asymmetric():
    """Configurations spread over the limits, so some joints sit inside
    the 0.15 band where the weight is non-zero; the metric keeps the
    reference's column weighting, M[i, j] = w[j] H[i, j]."""
    rng = np.random.default_rng(4)
    low, high = robots.TWO_JOINT_Q_LIM_LOW, robots.TWO_JOINT_Q_LIM_HIGH
    q = rng.uniform(low, high, (B, 1, 2)).astype(np.float32)
    qd = rng.uniform(-2, 2, (B, 1, 2)).astype(np.float32)
    pol = v1.joint_limit_avoidance(low, high, gamma_p=0.3, gamma_d=1.0)
    a, M = pol.accel_metric(pol.params, torch.tensor(q), torch.tensor(qd),
                            None)
    jpol = jv1.joint_limit_avoidance(low, high, gamma_p=0.3, gamma_d=1.0)
    want = jax_leaf(lambda p, a_, b_: jpol.accel_metric(p, a_, b_, None),
                    jpol.params, q, qd)
    assert_leaf_close(a, want[0], "a")
    assert_leaf_close(M, want[1], "M")
    assert float((M - M.transpose(-1, -2)).abs().max()) > 1e-3


@pytest.fixture(scope="module", params=["two_joint/05_obstacle_avoidance",
                                        "ur5/02_obstacle_avoidance"])
def relative_point_scene(request):
    """One tick's taskmap derivatives of a scene whose collision policy
    chains multi_fk_frames and frames_relative_points, in both packages on
    the same 8 states."""
    name, n_env = request.param, 8
    rng = np.random.default_rng(5)
    jenv = jenvs.make(name)
    states = jenvs.make_batched_reset(jenv, n_env)(jax.random.PRNGKey(0))
    n = states.sim.q.shape[1]
    q = (np.asarray(states.sim.q)
         + rng.uniform(-0.3, 0.3, (n_env, n))).astype(np.float32)
    qd = rng.uniform(-0.5, 0.5, (n_env, n)).astype(np.float32)
    states = dataclasses.replace(states, sim=dataclasses.replace(
        states.sim, q=jnp.asarray(q), qd=jnp.asarray(qd)))
    params = jenv.gather_params()

    def tick(state):
        q, qd, _, ctxs, fk = jbase._policy_inputs(jenv, state, params)
        return jcore._taskmap_derivatives_analytic(jenv.policies, q, qd, ctxs,
                                                   fk=fk)
    want = jax.tree.map(np.asarray, jax.jit(jax.vmap(tick))(states))
    env = envs.make(name, device="cpu")
    state = convert.state_from_numpy(
        jax.tree.map(np.asarray, jax_state_leaves(states)), "cpu")
    q, qd, _, ctxs, fk = _policy_inputs(
        env, state, convert.params_from_numpy(
            jax.tree.map(np.asarray, params), "cpu"))
    got = _taskmap_derivatives_analytic(env.policies, q, qd, ctxs, fk=fk)
    return env, got, want


def test_relative_point_taskmap_derivatives_match_jax(relative_point_scene):
    """(x, ẋ, J, c) of the grouped collision policy: L x K points of 3 rows,
    (B, 3, 3) on the two-joint robot and (B, 6, 3) on the UR5, one
    obstacle."""
    env, got, want = relative_point_scene
    k = [p.name for p in env.policies].index("collision_avoidance")
    L = len(env.model.collision_frames)
    assert tuple(got[0][k].shape) == (8, L, 3)
    for name, g, w in zip(("x", "xd", "J", "c"), got, want):
        w = np.asarray(w[k])
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g[k].numpy(), w, atol=REL * scale, rtol=0,
                                   err_msg=name)


MODELS = {"two_joint": (robots.two_joint_robot, jrobots.two_joint_robot),
          "ur5": (robots.ur5, jrobots.ur5)}


@pytest.mark.parametrize("name", MODELS)
def test_plain_fk_derivatives_match_jax_on_new_models(name):
    """K3's plain version (the CPU wrapper, which launches nothing) on the
    two-joint robot (F = 3, n = 2) and the UR5 (F = 7, n = 6)."""
    model, jmodel = (f() for f in MODELS[name])
    rng = np.random.default_rng(6)
    q = rng.uniform(-1.2, 1.2, (32, model.n_q)).astype(np.float32)
    qd = rng.uniform(-1.0, 1.0, (32, model.n_q)).astype(np.float32)
    want = jax.jit(jax.vmap(lambda a, b: jfkd.fk_derivatives(jmodel, a, b)))(
        jnp.asarray(q), jnp.asarray(qd))
    before = cuda_fk.fk_derivatives_batched.launches
    got = cuda_fk.fk_derivatives_batched(model, torch.tensor(q),
                                         torch.tensor(qd))
    assert cuda_fk.fk_derivatives_batched.launches == before
    for what, g, w in zip(("T16", "Td16", "J16", "c16"), got, want):
        assert tuple(g.shape) == w.shape, what
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=K3_ATOL,
                                   err_msg=what)


@pytest.mark.parametrize("batch", [1, 5, 13])
@pytest.mark.parametrize("name", MODELS)
def test_k3_store_map_on_new_models(name, batch):
    """K3's store map (8 envs per CTA, float4 stores; a J row of 16 n floats
    holds 4 n float4) reassembles every output element once at F = 3,
    n = 2, where a float4 spans two J rows, and at F = 7, n = 6; B = 1 is
    the single-state RmpCore call."""
    model = MODELS[name][0]()
    rng = np.random.default_rng(7)
    q = torch.tensor(rng.uniform(-1.2, 1.2, (batch, model.n_q)),
                     dtype=torch.float32)
    qd = torch.tensor(rng.uniform(-1.0, 1.0, (batch, model.n_q)),
                      dtype=torch.float32)
    got = replay_k3_stores(model, q, qd)
    want = fkd.fk_derivatives(model, q, qd)
    for what, g, w in zip(("T16", "Td16", "J16", "c16"), got, want):
        assert not np.isnan(g).any(), what
        np.testing.assert_allclose(g, w.numpy(), atol=K3_ATOL, err_msg=what)
