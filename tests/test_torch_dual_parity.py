"""5-tick parity of the port's dual_panda/handover (capsule and hull tier)
and of franka/03_self_avoidance in the hull tier against the JAX package,
batched, at B = 4 from the same perturbed states: the inter-arm and the
self-collision contexts are hull against hull through the plain PyTorch
GJK (ops/gjk.closest_points) on the port's side and XLA's on JAX's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu import envs as jenvs
from rmp_tpu_torch import convert, envs
from test_torch_scenes import jax_state_leaves

torch.set_num_threads(1)

B, T = 4, 5
QDD_TOL = 2e-3       # first-tick |Δq̈| <= QDD_TOL * max(1, |q̈|), env by env
Q_TOL = 5e-4         # |Δq| after T ticks (tests/test_torch_scenes.py's)


def perturbed_jax_states(jenv, seed: int):
    """B reset states of the JAX scene moved by q ± 0.1, q̇ ± 0.05."""
    rng = np.random.default_rng(seed)
    states = jenvs.make_batched_reset(jenv, B)(jax.random.PRNGKey(0))
    n = states.sim.q.shape[1]
    q = (np.asarray(states.sim.q)
         + rng.uniform(-0.1, 0.1, (B, n))).astype(np.float32)
    qd = rng.uniform(-0.05, 0.05, (B, n)).astype(np.float32)
    return dataclasses.replace(states, sim=dataclasses.replace(
        states.sim, q=jnp.asarray(q), qd=jnp.asarray(qd)))


def assert_parity(name, geometry, seed):
    """T ticks of the port's batched rollout (CPU, plain kernels) against
    JAX's from the same states: the first tick's q̈ env by env, q after T
    ticks, the bookkeeping and the goals."""
    jenv = jenvs.make(name)
    jenv.collision_geometry = geometry
    states = perturbed_jax_states(jenv, seed)
    params = jenv.gather_params()
    jfinal, jaux = jax.jit(jenvs.make_batched_rollout(jenv, T))(states,
                                                                 params)
    env = envs.make(name, device="cpu")
    env.collision_geometry = geometry
    state = convert.state_from_numpy(
        jax.tree.map(np.asarray, jax_state_leaves(states)), "cpu")
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        "cpu")
    assert env.resolve_method == jenv.resolve_method
    final, aux = envs.make_batched_rollout(env, T)(state, tparams)
    assert not aux["solved"].any() and not np.asarray(jaux["solved"]).any()
    want = np.asarray(jaux["qdd"])[:, 0]
    err = np.abs(aux["qdd"][:, 0].numpy() - want).max(axis=1)
    limit = QDD_TOL * np.maximum(1.0, np.abs(want).max(axis=1))
    assert (err <= limit).all(), f"first-tick q̈: {err} (limits {limit})"
    q_err = np.abs(final.sim.q.numpy() - np.asarray(jfinal.sim.q)).max()
    assert q_err < Q_TOL, f"q after {T} ticks: {q_err}"
    for field in ("steps", "solved_count", "phase"):
        np.testing.assert_array_equal(getattr(final, field).numpy(),
                                      np.asarray(getattr(jfinal, field)))
    np.testing.assert_array_equal(final.sim.goal.numpy(),
                                  np.asarray(jfinal.sim.goal))
    return final


@pytest.mark.parametrize("geometry", ["capsule", "hull"])
def test_dual_handover_tick_parity_with_jax(geometry):
    final = assert_parity("dual_panda/handover", geometry, 11)
    assert final.sim.q.shape == (B, 18) and final.sim.goal.shape == (B, 2, 3)


def test_self_avoidance_hull_tier_tick_parity_with_jax():
    """franka/03's context_fn in the hull tier: the 20 self pairs hull
    against hull, as robot_self_distances_hull now gives them."""
    assert_parity("franka/03_self_avoidance", "hull", 12)
