"""The port's exact-hull collision tier (env.collision_geometry = 'hull') on
the CPU, through the plain version of K4: the rollout against the JAX
package's batched rollout on its per-env branch (B % 128 != 0), the warm
carry's seed and its survival through a resample, and the K4 wrapper's
input checks. The kernel-path branch (B % 128 == 0) is held against JAX in
tests/test_torch_hull_kernel_path.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu import envs as jenvs
from rmp_tpu_torch import convert, envs
from rmp_tpu_torch.core import fk_bundle
from rmp_tpu_torch.envs.base import ee_position
from rmp_tpu_torch.models import kinematics as K
from rmp_tpu_torch.ops import cuda_gjk
from rmp_tpu_torch.sim.data import PAIRS_KEY, distance_context_batched

torch.set_num_threads(1)

SCENE = "franka/06_cluttered_environment"


def jax_state_leaves(state):
    obs = state.sim.obstacles
    return dict(q=state.sim.q, qd=state.sim.qd, t=state.sim.t,
                goal=state.sim.goal, steps=state.steps,
                solved_count=state.solved_count, phase=state.phase,
                goal_best=state.goal_best, no_progress=state.no_progress,
                gjk_warm=state.gjk_warm,
                obstacles=dict(p0=obs.p0, p1=obs.p1, radius=obs.radius,
                               kinds=obs.kinds))


def hull_env(device="cpu"):
    env = envs.make(SCENE, device=device)
    env.collision_geometry = "hull"
    env.resolve_method = "solve"
    return env


def test_rollout_matches_jax_per_env_branch():
    """8 perturbed reset states, 5 ticks of the hull tier: the port (CPU,
    every pair, cold, 10 iterations) against the JAX batched rollout, whose
    per-env hull query runs the XLA GJK. Tolerances of
    tests/test_torch_envs.py."""
    B, T = 8, 5
    rng = np.random.default_rng(41)
    jenv = jenvs.make(SCENE)
    jenv.collision_geometry = "hull"
    jenv.resolve_method = "solve"
    states = jenvs.make_batched_reset(jenv, B)(jax.random.PRNGKey(0))
    assert states.gjk_warm is None
    q = (np.asarray(states.sim.q)
         + rng.uniform(-0.1, 0.1, (B, 9))).astype(np.float32)
    qd = rng.uniform(-0.05, 0.05, (B, 9)).astype(np.float32)
    states = dataclasses.replace(states, sim=dataclasses.replace(
        states.sim, q=jnp.asarray(q), qd=jnp.asarray(qd)))
    params = jenv.gather_params()
    jfinal, jaux = jax.jit(jenvs.make_batched_rollout(jenv, T))(states, params)

    env = hull_env()
    tstate = convert.state_from_numpy(
        jax.tree.map(np.asarray, jax_state_leaves(states)), "cpu")
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        "cpu")
    final, aux = envs.make_batched_rollout(env, T)(tstate, tparams)
    assert final.gjk_warm is None
    qdd_err = np.abs(aux["qdd"][:, 0].numpy()
                     - np.asarray(jaux["qdd"])[:, 0]).max()
    assert qdd_err < 2e-3, f"first-tick q̈ divergence {qdd_err}"
    q_err = np.abs(final.sim.q.numpy() - np.asarray(jfinal.sim.q)).max()
    assert q_err < 5e-4, f"q divergence after {T} ticks: {q_err}"
    for name in ("steps", "solved_count", "phase"):
        np.testing.assert_array_equal(getattr(final, name).numpy(),
                                      np.asarray(getattr(jfinal, name)))


def test_reset_seeds_the_converged_cold_witness():
    """make_batched_reset seeds gjk_warm with pos_on_obstacle - pos_on_link
    of a cold 10-iteration query (not zeros), after
    tests/test_pallas_gjk.py::test_gjk_warm_seed_is_converged_witness; a
    batch off the multiple of 128 carries nothing."""
    env = hull_env()
    states = envs.make_batched_reset(env, 128)()
    warm = states.gjk_warm
    assert warm is not None and warm.shape == (128, 10, 7, 3)
    assert torch.isfinite(warm).all() and (warm.abs() > 1e-6).any()
    T_all = K.fk_all(env.model, states.sim.q)
    ctx, _ = distance_context_batched(env.model, T_all, states.sim.obstacles,
                                      "hull", iters=10)
    pairs = ctx[PAIRS_KEY]
    np.testing.assert_allclose(
        warm.numpy(), (pairs["pos_on_obstacle"] - pairs["pos_on_link"]).numpy(),
        atol=1e-6)
    assert envs.make_batched_reset(env, 8)().gjk_warm is None
    env.collision_geometry = "capsule"
    assert envs.make_batched_reset(env, 128)().gjk_warm is None


def test_warm_carry_survives_a_resample():
    """Envs that reach their goal this tick resample it (phase + 1); their
    carry is the tick's witness direction like every other env's."""
    env = hull_env()
    states = envs.make_batched_reset(env, 128)()
    sim = states.sim
    goal = torch.where(torch.arange(128)[:, None] < 64,
                       ee_position(env, sim), sim.goal)
    states = dataclasses.replace(states, sim=dataclasses.replace(sim,
                                                                 goal=goal))
    fk = fk_bundle(env.policies, sim.q, sim.qd)
    T16 = fk[id(env.model)].T16
    _, want = distance_context_batched(
        env.model, T16.reshape(128, -1, 4, 4), sim.obstacles, "hull",
        warm=states.gjk_warm)
    out, aux = envs.make_batched_control_step(env)(states,
                                                   env.gather_params())
    resampled = aux["resample"]
    assert resampled[:64].all() and not resampled[64:].any()
    assert (out.phase[:64] == 1).all() and (out.phase[64:] == 0).all()
    torch.testing.assert_close(out.gjk_warm, want, atol=0, rtol=0)


def k4_operands(L=2, M=3, V=5, B=4):
    f = dict(dtype=torch.float32)
    return dict(verts=torch.zeros(L, V, 3, **f), R=torch.zeros(L, 3, 3, B, **f),
                t=torch.zeros(L, 3, B, **f), p0=torch.zeros(L, M, 3, B, **f),
                p1=torch.zeros(L, M, 3, B, **f), an=torch.zeros(L, M, 3, B, **f),
                radius=torch.zeros(L, M, 1, B, **f),
                is_cyl=torch.zeros(L, M, 1, B, **f),
                d0=torch.ones(L, M, 3, B, **f))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_k4_wrapper_rejects_what_the_kernel_does_not_take(device):
    ok = {k: v.to(device) for k, v in k4_operands().items()}
    for name in ok:
        bad = dict(ok, **{name: ok[name].double()})
        with pytest.raises(TypeError, match=name):
            cuda_gjk.gjk_hull_obstacles(**bad)
        bad = dict(ok, **{name: ok[name][..., :1]})
        with pytest.raises(ValueError):
            cuda_gjk.gjk_hull_obstacles(**bad)
    if device == "meta":
        with pytest.raises(ValueError, match="no K4 kernel"):
            cuda_gjk.gjk_hull_obstacles(**ok)
    else:
        pa, pb, dist = cuda_gjk.gjk_hull_obstacles(**ok)
        assert pa.shape == pb.shape == (2, 3, 3, 4) and dist.shape == (2, 3, 4)
