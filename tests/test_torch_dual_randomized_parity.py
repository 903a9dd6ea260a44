"""5-tick parity of the port's dual_panda/randomized_clutter against the
JAX package in both collision tiers, batched, at B = 4 from JAX's own
reset (random obstacles, jittered starts, per-arm goals, the dual
scratch): no maneuver and no goal event fires in these ticks, so no
random draw is kept and the two runs take the same path. The hull tier
runs every obstacle pair cold through K4's plain version and the inter-arm
pairs hull against hull."""
import jax
import numpy as np
import pytest
import torch

from rmp_tpu import envs as jenvs
from rmp_tpu_torch import convert, envs
from test_torch_dual import jax_leaves

torch.set_num_threads(1)

SCENE = "dual_panda/randomized_clutter"
B, T = 4, 5
QDD_TOL = 2e-3       # first-tick |Δq̈| <= QDD_TOL * max(1, |q̈|), env by env
Q_TOL = 5e-4         # |Δq| after T ticks (tests/test_torch_scenes.py's)


@pytest.mark.parametrize("geometry", ["capsule", "hull"])
def test_dual_randomized_tick_parity_with_jax(geometry):
    jenv = jenvs.make(SCENE)
    jenv.collision_geometry = geometry
    states = jenvs.make_batched_reset(jenv, B)(jax.random.PRNGKey(2))
    params = jenv.gather_params()
    jfinal, jaux = jax.jit(jenvs.make_batched_rollout(jenv, T))(states,
                                                                 params)
    env = envs.make(SCENE, device="cpu")
    env.collision_geometry = geometry
    state = convert.state_from_numpy(jax_leaves(states), "cpu")
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        "cpu")
    final, aux = envs.make_batched_rollout(env, T)(state, tparams)
    assert not np.asarray(jaux["resample"]).any()
    assert not aux["resample"].any()
    want = np.asarray(jaux["qdd"])[:, 0]
    err = np.abs(aux["qdd"][:, 0].numpy() - want).max(axis=1)
    limit = QDD_TOL * np.maximum(1.0, np.abs(want).max(axis=1))
    assert (err <= limit).all(), f"first-tick q̈: {err} (limits {limit})"
    q_err = np.abs(final.sim.q.numpy() - np.asarray(jfinal.sim.q)).max()
    assert q_err < Q_TOL, f"q after {T} ticks: {q_err}"
    for field in ("steps", "solved_count", "phase", "no_progress"):
        np.testing.assert_array_equal(getattr(final, field).numpy(),
                                      np.asarray(getattr(jfinal, field)))
    for k in ("man_ticks", "man_count", "noprog"):
        np.testing.assert_array_equal(final.scratch[k].numpy(),
                                      np.asarray(jfinal.scratch[k]), err_msg=k)
    np.testing.assert_allclose(final.scratch["d"].numpy(),
                               np.asarray(jfinal.scratch["d"]), atol=Q_TOL)
    np.testing.assert_array_equal(final.sim.goal.numpy(),
                                  np.asarray(jfinal.sim.goal))
    assert final.gjk_warm is None
