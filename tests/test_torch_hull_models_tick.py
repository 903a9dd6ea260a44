"""One tick of the two-joint robot's and the UR5's hull tiers at B = 128
(the batched semantics: broad phase, the warm carry seeded by a cold query,
K4's plain version on the CPU) against the JAX package's batched step on its
kernel path, the Pallas GJK (and, for the UR5, resolve) kernels in interpret
mode, as tests/test_torch_hull_kernel_path.py runs the Panda's."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu import envs as jenvs
from rmp_tpu.envs import base as jbase
from rmp_tpu.models import kinematics as JK
from rmp_tpu.sim import collision as JC
from rmp_tpu.sim.data import distance_context_batched as jax_context
from rmp_tpu_torch import convert, envs
from test_torch_hull_models import HULL_SCENES
from test_torch_scenes import jax_state_leaves

torch.set_num_threads(1)


@pytest.mark.parametrize("name", HULL_SCENES)
def test_hull_tier_one_tick_matches_jax_kernel_path(name, monkeypatch):
    """One tick at B = 128 (the batched semantics: broad phase, warm carry
    seeded by a cold query) against JAX's batched step on its kernel path,
    the Pallas GJK (and, for the UR5, resolve) kernels in interpret mode,
    from states moved by q ± 0.1, q̇ ± 0.05."""
    from jax.experimental.pallas import tpu as pltpu
    B = 128
    jenv = jenvs.make(name)
    states = jenvs.make_batched_reset(jenv, B)(jax.random.PRNGKey(0))
    jenv.collision_geometry = "hull"
    n = states.sim.q.shape[1]
    rng = np.random.default_rng(43)
    q = jnp.asarray(np.asarray(states.sim.q)
                    + rng.uniform(-0.1, 0.1, (B, n)), jnp.float32)
    qd = jnp.asarray(rng.uniform(-0.05, 0.05, (B, n)), jnp.float32)
    T_all = jax.vmap(lambda x: JK.fk_all(jenv.model, x))(q)
    _, warm = jax_context(jenv.model, T_all, states.sim.obstacles,
                          geometry="hull", iters=10)
    states = dataclasses.replace(
        states, gjk_warm=warm,
        sim=dataclasses.replace(states.sim, q=q, qd=qd))
    params = jenv.gather_params()
    leaves = jax.tree.map(np.asarray, dict(jax_state_leaves(states),
                                           gjk_warm=states.gjk_warm))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(JC, "robot_obstacle_distances_hull_batched",
                        functools.partial(
                            JC.robot_obstacle_distances_hull_batched,
                            interpret=True))
    with pltpu.force_tpu_interpret_mode():
        jout, jaux = jax.jit(jbase.make_batched_control_step(jenv))(states,
                                                                    params)
    monkeypatch.undo()

    env = envs.make(name, device="cpu")
    env.collision_geometry = "hull"
    out, aux = envs.make_batched_control_step(env)(
        convert.state_from_numpy(leaves, "cpu"),
        convert.params_from_numpy(jax.tree.map(np.asarray, params), "cpu"))
    want = np.asarray(jaux["qdd"])
    err = np.abs(aux["qdd"].numpy() - want).max(axis=1)
    assert (err <= 2e-3 * np.maximum(1.0, np.abs(want).max(axis=1))).all(), \
        err.max()
    q_err = np.abs(out.sim.q.numpy() - np.asarray(jout.sim.q)).max()
    assert q_err < 5e-4, f"q divergence {q_err}"
    got, want = out.gjk_warm.numpy(), np.asarray(jout.gjk_warm)
    assert np.isfinite(got).all()
    diff = np.linalg.norm(got - want, axis=-1)
    assert np.percentile(diff, 99) < 1e-4, np.percentile(diff, 99)
