"""Gradients of whole rollouts through the port, against the JAX package's:
tests/test_differentiable.py's three cases, with the loss of each package's
own tune_gains (`experiments/tune_gains.py::make_loss` and
`rmp_tpu_torch.experiments.tune_gains.make_loss`) on the same reset
states, and rematerialization with a resample inside a recomputed tick."""
import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

from experiments.tune_gains import make_loss as jax_make_loss  # noqa: E402
from rmp_tpu import envs as jenvs  # noqa: E402
from rmp_tpu_torch import envs  # noqa: E402
from rmp_tpu_torch.envs.neural_clutter import make_neural_clutter_env  # noqa: E402
from rmp_tpu_torch.experiments import common, tune_gains  # noqa: E402
from rmp_tpu_torch.experiments import train_neural_clutter  # noqa: E402

torch.set_num_threads(1)


def scenes(name: str, geometry: str = "capsule"):
    """The JAX and the port's scene, set up as tune_gains sets it."""
    out = []
    for env in (jenvs.make(name), envs.make(name, device="cpu")):
        env.resolve_method = "cholesky"
        env.on_solved = None
        env.collision_geometry = geometry
        out.append(env)
    return out


def port_value_and_grad(loss, theta):
    theta = {k: v.detach().clone().requires_grad_() for k, v in theta.items()}
    val = loss(theta)
    grads = torch.autograd.grad(val, list(theta.values()))
    return float(val.detach()), np.asarray([float(g) for g in grads])


def jax_value_and_grad(loss, theta):
    val, g = jax.jit(jax.value_and_grad(loss))(theta)
    return float(val), np.asarray([float(g["log_p"]), float(g["log_d"])])


def test_rollout_gradients_match_jax_and_descend():
    """franka/01 with 'cholesky', 4 envs x 20 ticks: the loss within 1e-6
    and its gradient within 1e-4 relative of JAX's (measured on the CPU
    host: 5.8e-7 on the loss's 2.87e-2, 7.9e-6 relative on the gradient);
    one step along -0.2 g lowers the port's loss."""
    jenv, env = scenes("franka/01_target_rmp_only")
    jloss, jtheta, _ = jax_make_loss(jenv, batch=4, n_ticks=20)
    loss, theta, keys = tune_gains.make_loss(env, 4, 20)
    assert keys == ("alpha", "beta")
    v_jax, g_jax = jax_value_and_grad(jloss, jtheta)
    v0, g = port_value_and_grad(loss, theta)
    assert np.all(np.isfinite(g)) and np.linalg.norm(g) > 1e-6
    assert abs(v0 - v_jax) < 1e-6, (v0, v_jax)
    np.testing.assert_allclose(g, g_jax, rtol=1e-4)
    theta2 = {k: theta[k] - 0.2 * float(gk) for k, gk in zip(theta, g)}
    with torch.no_grad():
        v1 = float(loss(theta2))
    assert v1 < v0, (v0, v1)


def test_hull_mode_rollout_gradients_match_jax():
    """two_joint/05 in the hull tier, 2 envs x 6 ticks: every pair through
    K4's Function (the envelope rule), where JAX's per-env path
    differentiates its XLA iterations. Held by JAX's own kernel-vs-XLA
    measure (tests/test_pallas_gjk.py): cosine > 0.999 and a norm ratio in
    (0.98, 1.02) (measured: cosine 1 - 2e-8, ratio 1.0011); the loss
    within 1e-5 (measured 2.4e-7)."""
    jenv, env = scenes("two_joint/05_obstacle_avoidance", "hull")
    jloss, jtheta, _ = jax_make_loss(jenv, batch=2, n_ticks=6)
    loss, theta, _ = tune_gains.make_loss(env, 2, 6)
    v_jax, g_jax = jax_value_and_grad(jloss, jtheta)
    v, g = port_value_and_grad(loss, theta)
    assert np.isfinite(v) and np.all(np.isfinite(g))
    assert np.linalg.norm(g) > 1e-6
    assert abs(v - v_jax) < 1e-5, (v, v_jax)
    cos = float(g @ g_jax / (np.linalg.norm(g) * np.linalg.norm(g_jax)))
    ratio = float(np.linalg.norm(g) / np.linalg.norm(g_jax))
    assert cos > 0.999, cos
    assert 0.98 < ratio < 1.02, ratio


def test_obstacle_scene_rollout_gradients_match_jax():
    """franka/06 with 'cholesky', 2 envs x 4 ticks: the gradient flows
    through the grouped distance taskmap's curvature term (a nested jvp
    that the reverse-mode-safe distance serves, taskmaps._distance), K3's
    Function and the capsule distances; within 1e-4 relative of JAX's
    (measured on the CPU host: 8.6e-8; the loss 8.9e-8 apart)."""
    jenv, env = scenes("franka/06_cluttered_environment")
    jloss, jtheta, _ = jax_make_loss(jenv, batch=2, n_ticks=4)
    loss, theta, _ = tune_gains.make_loss(env, 2, 4)
    v_jax, g_jax = jax_value_and_grad(jloss, jtheta)
    v, g = port_value_and_grad(loss, theta)
    assert abs(v - v_jax) < 1e-5, (v, v_jax)
    np.testing.assert_allclose(g, g_jax, rtol=1e-4)


def test_remat_rollout_same_values_and_grads():
    """Rematerialized rollouts: the same value (within 1e-6) and gradients
    (rtol 1e-4) as without remat, on two_joint/01 at 4 envs x 8 ticks, and
    through the batched rollout of franka/06 ('solve': K1's Function) at
    2 envs x 3 ticks."""
    for name, B, T, fused in (("two_joint/01_target_rmp_only", 4, 8, False),
                              ("franka/06_cluttered_environment", 2, 3,
                               True)):
        env = envs.make(name, device="cpu")
        if fused:
            env.resolve_method = "solve"
        loss_a, init, _ = tune_gains.make_loss(env, B, T,
                                               fused_resolve=fused)
        loss_b, _, _ = tune_gains.make_loss(env, B, T, remat=True,
                                            fused_resolve=fused)
        va, ga = port_value_and_grad(loss_a, init)
        vb, gb = port_value_and_grad(loss_b, init)
        assert abs(va - vb) < 1e-6, (name, va, vb)
        np.testing.assert_allclose(gb, ga, rtol=1e-4, err_msg=name)


def solved_at_start(env, B: int):
    """Reset states of `env` whose goals sit at the EE: every env solves at
    the first tick and on_solved draws it a new goal inside that tick."""
    states = envs.make_batched_reset(env, B)()
    ee = envs.base.ee_position(env, states.sim)
    return dataclasses.replace(states, sim=dataclasses.replace(
        states.sim, goal=ee.clone()))


@pytest.mark.parametrize("fused", [False, True])
def test_remat_redraws_the_forward_resample(fused):
    """two_joint/01 resamples a solved env's goal from EnvState.rng inside
    the tick. With every env solved at tick 0 and the remat'd tick
    recomputed in the backward: the gradient equals the one without remat
    (rtol 1e-5), the goals drawn are the same, and after forward and
    backward the env's generator stands where the run without remat leaves
    it. (This draw comes after the tick's last saved tensor, where
    torch.utils.checkpoint's early stop ends a recomputation, so a redraw
    shows in the next test, whose draw opens the tick.)"""
    env = envs.make("two_joint/01_target_rmp_only", device="cpu")
    results = []
    for remat in (False, True):
        states = solved_at_start(env, 4)
        make = envs.make_batched_rollout if fused else envs.make_rollout
        rollout = make(env, 6, remat=remat)
        base = env.gather_params()
        log_p = torch.tensor(float(base[0]["alpha"])).log().requires_grad_()
        prm = dict(base[0], alpha=torch.exp(log_p))
        final, aux = rollout(states, (prm,) + tuple(base[1:]))
        assert bool(aux["resample"][:, 0].all())
        d = torch.linalg.vector_norm(aux["ee"][:, -1] - final.sim.goal,
                                     dim=-1)
        (g,) = torch.autograd.grad(d.mean(), log_p)
        results.append((float(g), final.sim.goal.detach(),
                        states.rng.get_state()))
    (g0, goal0, rng0), (g1, goal1, rng1) = results
    assert g0 != 0.0
    np.testing.assert_allclose(g1, g0, rtol=1e-5)
    torch.testing.assert_close(goal1, goal0, rtol=0, atol=0)
    assert torch.equal(rng1, rng0)


def test_remat_redraws_the_randomized_pre_tick():
    """The clutter trainer's case: franka/randomized_cluttered's pre_tick
    draws a normal per env from EnvState.rng at the start of every tick,
    before the tick's graph, so a recomputation that drew from the env's
    generator would advance it and build its graph on other numbers. Per-env
    losses' gradients in the learned leaf's net (one backward through
    per-env replicas, 3 envs x 3 ticks) with remat equal those without
    (rtol 1e-5), and the generator ends where the run without remat
    leaves it."""
    env = make_neural_clutter_env("cpu", gen=torch.Generator().manual_seed(1),
                                  hidden=(6,), train=True)
    base = env.gather_params()
    slot = len(base) - 1
    weights = dict(clear_margin=0.05, pen_margin=0.005, w_collision=10.0,
                   w_pen=300.0, w_effort=1e-4)
    results = []
    for remat in (False, True):
        states = envs.make_batched_reset(env, 3, seed=2)()
        rollout = envs.make_rollout(env, 3, remat=remat)
        val, grad, _, _ = train_neural_clutter.per_env_value_and_grad(
            rollout, base, slot, base[slot]["net"], states, weights, 3.0)
        results.append((float(val), grad, states.rng.get_state()))
    (v0, g0, rng0), (v1, g1, rng1) = results
    assert abs(v1 - v0) <= 1e-6 * max(1.0, abs(v0))
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-5, atol=1e-9)
    assert torch.equal(rng1, rng0)
