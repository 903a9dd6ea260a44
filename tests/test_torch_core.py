"""The port's capsule distances, distance context, taskmap derivatives, v2
leaves and structured row blocks against the JAX package, on 8 perturbed
states of the flagship scene (q ± 0.3, q̇ ± 0.5 around the ready pose)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu import core as jcore
from rmp_tpu import envs as jenvs
from rmp_tpu.envs import base as jbase
from rmp_tpu.models import kinematics as jK
from rmp_tpu.sim import collision as jcollision
from rmp_tpu_torch import convert, envs
from rmp_tpu_torch.core import (_taskmap_derivatives_analytic,
                                evaluate_policies,
                                policy_row_blocks_structured)
from rmp_tpu_torch.envs.base import _policy_inputs
from rmp_tpu_torch.ops.cuda_resolve import pullback_resolve_structured
from rmp_tpu_torch.sim import collision
from rmp_tpu_torch.sim.data import PAIRS_KEY

torch.set_num_threads(1)

SCENE = "franka/06_cluttered_environment"
B = 8
REL = 1e-4           # |Δ| <= REL * max(1, max |reference|), per block


def assert_close_scaled(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=REL * scale, rtol=0,
                               err_msg=what)


def jax_state_leaves(state):
    obs = state.sim.obstacles
    return dict(q=state.sim.q, qd=state.sim.qd, t=state.sim.t,
                goal=state.sim.goal, steps=state.steps,
                solved_count=state.solved_count, phase=state.phase,
                goal_best=state.goal_best, no_progress=state.no_progress,
                obstacles=dict(p0=obs.p0, p1=obs.p1, radius=obs.radius,
                               kinds=obs.kinds))


@pytest.fixture(scope="module")
def scene():
    """JAX reference outputs and the port's inputs on the same states."""
    rng = np.random.default_rng(21)
    jenv = jenvs.make(SCENE)
    states = jenvs.make_batched_reset(jenv, B)(jax.random.PRNGKey(0))
    q = (np.asarray(states.sim.q)
         + rng.uniform(-0.3, 0.3, (B, 9))).astype(np.float32)
    qd = rng.uniform(-0.5, 0.5, (B, 9)).astype(np.float32)
    states = dataclasses.replace(states, sim=dataclasses.replace(
        states.sim, q=jnp.asarray(q), qd=jnp.asarray(qd)))
    params = jenv.gather_params()
    tag_box = []

    def tick(state):
        q, qd, params_b, ctxs, fk = jbase._policy_inputs(jenv, state, params)
        derivs = jcore._taskmap_derivatives_analytic(jenv.policies, q, qd,
                                                     ctxs, fk=fk)
        leaves = tuple(p.accel_metric(prm, x, xd, ctx) for p, prm, ctx, x, xd
                       in zip(jenv.policies, params_b, ctxs, *derivs[:2]))
        tags, blocks = jcore.policy_row_blocks_structured(
            jenv.policies, q, qd, params_b, ctxs, fk=fk)
        tag_box[:] = tags
        T_all = jK.fk_all(jenv.model, q)
        return T_all, ctxs[-1], derivs, leaves, blocks

    out = jax.tree.map(np.asarray, jax.jit(jax.vmap(tick))(states))
    env = envs.make(SCENE, device="cpu")
    tstate = convert.state_from_numpy(
        jax.tree.map(np.asarray, jax_state_leaves(states)), "cpu")
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        "cpu")
    return dict(jenv=jenv, jstates=states, env=env, state=tstate,
                params=tparams, tags=tuple(tag_box), T_all=out[0],
                ctx=out[1], derivs=out[2], leaves=out[3], blocks=out[4])


def test_robot_obstacle_distances_match_jax(scene):
    """Same world transforms into both: the capsule queries alone."""
    jenv, states = scene["jenv"], scene["jstates"]
    want = jax.vmap(lambda T, o: jcollision.robot_obstacle_distances(
        jenv.model, T, o))(jnp.asarray(scene["T_all"]), states.sim.obstacles)
    got = collision.robot_obstacle_distances(
        scene["env"].model, torch.tensor(scene["T_all"]),
        scene["state"].sim.obstacles)
    for name, g, w in zip(("pos_on_link", "pos_on_obstacle", "normal",
                           "distance"), got, want):
        assert_close_scaled(g, w, name)


def test_distance_context_matches_jax(scene):
    _, _, _, ctxs, _ = _policy_inputs(scene["env"], scene["state"],
                                      scene["params"])
    got, want = ctxs[-1], scene["ctx"]
    assert set(got) == set(want)
    for key in want:
        assert_close_scaled(got[key], want[key], key)


def test_flagship_pairs_context_is_the_grouped_policy_ctx(scene):
    q, qd, _, ctxs, _ = _policy_inputs(scene["env"], scene["state"],
                                       scene["params"])
    assert [p.ctx_key for p in scene["env"].policies][-1] == PAIRS_KEY
    assert ctxs[-1]["distance"].shape == (B, 10, 7)


@pytest.mark.parametrize("policy", range(5))
def test_taskmap_derivatives_match_jax(scene, policy):
    """(x, ẋ, J, c) per policy; the grouped obstacle policy's rows are the
    70 link x obstacle distances (frozen-offset trick under torch.func)."""
    q, qd, _, ctxs, fk = _policy_inputs(scene["env"], scene["state"],
                                        scene["params"])
    got = _taskmap_derivatives_analytic(scene["env"].policies, q, qd, ctxs,
                                        fk=fk)
    for name, g, w in zip(("x", "xd", "J", "c"), got, scene["derivs"]):
        assert_close_scaled(g[policy], w[policy], f"{name}[{policy}]")


@pytest.mark.parametrize("policy", range(5))
def test_v2_leaf_matches_jax(scene, policy):
    """(a, M) of each leaf on the JAX package's own (x, ẋ)."""
    env = scene["env"]
    _, _, params_b, ctxs, _ = _policy_inputs(env, scene["state"],
                                             scene["params"])
    x, xd = (torch.tensor(scene["derivs"][k][policy]) for k in (0, 1))
    p = env.policies[policy]
    a, M = p.accel_metric(params_b[policy], x, xd, ctxs[policy])
    want_a, want_M = scene["leaves"][policy]
    assert_close_scaled(a, want_a, f"a[{p.name}]")
    assert_close_scaled(M, want_M, f"M[{p.name}]")


def test_structured_row_blocks_match_jax(scene):
    q, qd, params_b, ctxs, fk = _policy_inputs(scene["env"], scene["state"],
                                               scene["params"])
    tags, blocks = policy_row_blocks_structured(
        scene["env"].policies, q, qd, params_b, ctxs, fk=fk)
    assert tags == scene["tags"] == ("dense", "identity", "identity",
                                     "identity", "scalar")
    for i, (blk, want) in enumerate(zip(blocks, scene["blocks"])):
        for j, (g, w) in enumerate(zip(blk, want)):
            assert_close_scaled(g, w, f"block {i} ({tags[i]}) part {j}")


def test_evaluate_policies_solve_equals_structured_resolve(scene):
    """The per-policy pullback of core.evaluate_policies and the structured
    blocks through K1's plain version solve the same system."""
    env = scene["env"]
    q, qd, params_b, ctxs, fk = _policy_inputs(env, scene["state"],
                                               scene["params"])
    tags, blocks = policy_row_blocks_structured(env.policies, q, qd,
                                                params_b, ctxs, fk=fk)
    want = pullback_resolve_structured(tags, blocks)
    got = evaluate_policies(env.policies, q, qd, params_b, ctxs,
                            method="solve", fk=fk)
    assert_close_scaled(got, want, "qdd")
