"""One tick of the port's hull tier at B = 128 (top-3 broad phase, warm
start, the plain version of K4 on the CPU) against the JAX package's batched
step on its kernel path: the Pallas GJK and resolve kernels in interpret
mode. JAX takes that path only on a TPU backend, so the test reports one
(`jax.default_backend`) and routes the hull query to interpret mode; nothing
in the JAX package changes. Only this test pins the broad phase and the warm
carry against JAX: its per-env CPU branch runs cold over every pair."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rmp_tpu import envs as jenvs
from rmp_tpu.envs import base as jbase
from rmp_tpu.models import kinematics as JK
from rmp_tpu.sim import collision as JC
from rmp_tpu.sim.data import distance_context_batched as jax_context
from rmp_tpu_torch import convert, envs

torch.set_num_threads(1)

SCENE = "franka/06_cluttered_environment"
B = 128


def test_one_tick_matches_jax_kernel_path(monkeypatch):
    from jax.experimental.pallas import tpu as pltpu

    jenv = jenvs.make(SCENE)
    jenv.resolve_method = "solve"
    # reset in the capsule tier (no carry seeded), then seed it below
    states = jenvs.make_batched_reset(jenv, B)(jax.random.PRNGKey(0))
    jenv.collision_geometry = "hull"
    rng = np.random.default_rng(43)
    q = jnp.asarray(np.asarray(states.sim.q)
                    + rng.uniform(-0.1, 0.1, (B, 9)), jnp.float32)
    qd = jnp.asarray(rng.uniform(-0.05, 0.05, (B, 9)), jnp.float32)
    # moves near the ready pose keep |q̈| < 1 (wider ones bring links into
    # contact, where the repulsion drives q̈ to the 1000 clamp and fp32
    # rounding with it); contact and the handoff are held query by query
    # in tests/test_torch_gjk.py. The carry: a cold query at the moved
    # states, as JAX's reset computes it on the CPU
    T_all = jax.vmap(lambda x: JK.fk_all(jenv.model, x))(q)
    _, warm = jax_context(jenv.model, T_all, states.sim.obstacles,
                          geometry="hull", iters=10)
    states = dataclasses.replace(
        states, gjk_warm=warm,
        sim=dataclasses.replace(states.sim, q=q, qd=qd))
    params = jenv.gather_params()

    leaves = jax.tree.map(np.asarray, dict(
        q=states.sim.q, qd=states.sim.qd, t=states.sim.t,
        goal=states.sim.goal, steps=states.steps,
        solved_count=states.solved_count, phase=states.phase,
        goal_best=states.goal_best, no_progress=states.no_progress,
        gjk_warm=states.gjk_warm,
        obstacles=dict(p0=states.sim.obstacles.p0, p1=states.sim.obstacles.p1,
                       radius=states.sim.obstacles.radius,
                       kinds=states.sim.obstacles.kinds)))
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        "cpu")

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(JC, "robot_obstacle_distances_hull_batched",
                        functools.partial(
                            JC.robot_obstacle_distances_hull_batched,
                            interpret=True))
    with pltpu.force_tpu_interpret_mode():
        jout, jaux = jax.jit(jbase.make_batched_control_step(jenv))(states,
                                                                    params)
    monkeypatch.undo()

    env = envs.make(SCENE, device="cpu")
    env.collision_geometry = "hull"
    env.resolve_method = "solve"
    tstate = convert.state_from_numpy(leaves, "cpu")
    out, aux = envs.make_batched_control_step(env)(tstate, tparams)

    qdd_err = np.abs(aux["qdd"].numpy() - np.asarray(jaux["qdd"])).max()
    assert qdd_err < 2e-3, f"q̈ divergence {qdd_err}"
    q_err = np.abs(out.sim.q.numpy() - np.asarray(jout.sim.q)).max()
    assert q_err < 5e-4, f"q divergence {q_err}"
    # the next carry at the quantiles of tests/test_torch_gjk.py
    got, want = out.gjk_warm.numpy(), np.asarray(jout.gjk_warm)
    assert np.isfinite(got).all()
    diff = np.linalg.norm(got - want, axis=-1)
    assert np.percentile(diff, 99) < 1e-4, np.percentile(diff, 99)
    assert np.median(diff) < 1e-6, np.median(diff)
