"""Env.fused_blocks_dtype = 'bf16' in the port: the batched 'solve' step
hands K1 its row blocks in bfloat16 (the identity seed summed in float32
first) and K1 keeps every sum and the LU in float32, as the JAX package's
fused path does (rmp_tpu/ops/pallas_resolve.py block_dtype)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from rmp_tpu import envs as jenvs
from rmp_tpu_torch import convert, envs
from rmp_tpu_torch.envs.base import make_batched_control_step
from test_torch_envs import jax_state_leaves

torch.set_num_threads(1)

SCENE = "franka/06_cluttered_environment"
B = 128
CONTRACT_ATOL = 1e-2   # tests/test_pallas_resolve.py's bf16 contract on q
# The port's bf16 tick against JAX's, at the float32 tick parity's limits
# (tests/test_torch_scenes.py): the packages' float32 blocks part by an ulp
# or so, and an ulp can carry an element across a bfloat16 rounding
# boundary, which moves that element by 2^-8 of itself and q̈ by at most as
# much of that element's share: far inside these limits, and far below
# the bf16 path's own distance from float32 (2.9e-2 in q̈ on these states).
QDD_TOL = 2e-3       # |Δq̈| <= QDD_TOL * max(1, |q̈|), env by env
Q_TOL = 5e-4         # |Δq| after the tick


def start_states(env):
    states = envs.make_batched_reset(env, B)()
    rng = np.random.default_rng(12)
    n = env.model.n_q
    dq = torch.tensor(rng.uniform(-0.1, 0.1, (B, n)), dtype=torch.float32)
    dqd = torch.tensor(rng.uniform(-0.05, 0.05, (B, n)), dtype=torch.float32)
    return dataclasses.replace(states, sim=dataclasses.replace(
        states.sim, q=states.sim.q + dq, qd=dqd))


def test_bf16_rollout_meets_jax_contract():
    """tests/test_pallas_resolve.py's contract, on the port alone: franka/06
    with 'solve' at 128 envs x 2 ticks from its reset, as the JAX test
    runs it; the bf16 run's q is finite, within 1e-2 of the float32 run's,
    and not identical to it. (From start_states' moved states one env of
    128 parts by 4.6e-2 after 2 ticks, in both packages alike: the
    contract holds where the JAX test states it.)"""
    env = envs.make(SCENE, device="cpu")
    env.resolve_method = "solve"
    states = envs.make_batched_reset(env, B)()
    params = env.gather_params()
    f32, _ = envs.make_batched_rollout(env, 2, with_aux=False)(states, params)
    env.fused_blocks_dtype = "bf16"
    b16, _ = envs.make_batched_rollout(env, 2, with_aux=False)(states, params)
    q32, q16 = f32.sim.q.numpy(), b16.sim.q.numpy()
    gap = float(np.abs(q16 - q32).max())
    print(f"bf16 against float32 after 2 ticks: max|Δq| {gap:.3e}")
    assert np.isfinite(q16).all()
    np.testing.assert_allclose(q16, q32, atol=CONTRACT_ATOL)
    assert gap > 0.0, "bf16 path identical to f32?"


def test_bf16_tick_matches_jax_bf16_tick():
    """One tick of the port's bf16 step against JAX's fused bf16 step
    (K1 in interpret mode), from the same 128 moved states, at QDD_TOL and
    Q_TOL; the bf16 path's own distance from float32 printed beside."""
    from jax.experimental.pallas import tpu as pltpu

    jenv = jenvs.make(SCENE)
    jenv.resolve_method = "solve"
    env = envs.make(SCENE, device="cpu")
    env.resolve_method = "solve"
    states = start_states(env)
    jstates = jenvs.make_batched_reset(jenv, B)(jax.random.PRNGKey(0))
    jstates = dataclasses.replace(jstates, sim=dataclasses.replace(
        jstates.sim, q=states.sim.q.numpy(), qd=states.sim.qd.numpy()))
    jparams = jenv.gather_params()
    with pltpu.force_tpu_interpret_mode():
        j32, jaux32 = jenvs.make_batched_rollout(jenv, 1, fused_resolve=True)(
            jstates, jparams)
        jenv.fused_blocks_dtype = "bf16"
        j16, jaux16 = jenvs.make_batched_rollout(jenv, 1, fused_resolve=True)(
            jstates, jparams)
    env.fused_blocks_dtype = "bf16"
    tstate = convert.state_from_numpy(
        jax.tree.map(np.asarray, jax_state_leaves(jstates)), "cpu")
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        "cpu")
    final, aux = envs.make_batched_rollout(env, 1)(tstate, tparams)
    want = np.asarray(jaux16["qdd"])[:, 0]
    own = np.abs(want - np.asarray(jaux32["qdd"])[:, 0]).max(axis=1)
    err = np.abs(aux["qdd"][:, 0].numpy() - want).max(axis=1)
    print(f"bf16 tick, port vs JAX: max|Δq̈| {err.max():.3e}; the bf16 path "
          f"from float32 (JAX) {own.max():.3e}")
    assert np.isfinite(aux["qdd"].numpy()).all()
    assert (err <= QDD_TOL * np.maximum(1.0, np.abs(want).max(axis=1))).all()
    np.testing.assert_allclose(final.sim.q.numpy(), np.asarray(j16.sim.q),
                               atol=Q_TOL)


def test_fused_blocks_dtype_validated():
    env = envs.make(SCENE, device="cpu")
    env.fused_blocks_dtype = "bfloat16"   # a typo must not pass silently
    with pytest.raises(ValueError, match="fused_blocks_dtype"):
        make_batched_control_step(env)
