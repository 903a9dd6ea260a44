"""franka/neural_clutter (envs/neural_clutter.py) against the JAX package:
the scene is franka/randomized_cluttered with its grouped obstacle leaf
swapped for the learned one; the environment-variable overrides; training
mode's clearance aux; K1's plain version on a real tick's blocks (dense 3,
three identities and the learned leaf's 80 scalar rows) against JAX's K1
body run eagerly; 5 ticks at B = 8 from JAX's reset; and tests/
test_neural.py's trained-asset behaviour test at its size (32 envs x 100
ticks, no resampling)."""
import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch

from rmp_tpu import envs as jenvs
from rmp_tpu_torch import convert, envs
from rmp_tpu_torch.core import policy_row_blocks_structured
from rmp_tpu_torch.envs import base, neural_clutter
from rmp_tpu_torch.models import kinematics as K
from rmp_tpu_torch.ops import cuda_resolve
from rmp_tpu_torch.sim.collision import robot_obstacle_distances
from test_torch_conditioning import _to
from test_torch_dual import _assert_k1, jax_k1_body
from test_torch_randomized import jax_leaves
from test_torch_randomized_parity import Q_TOL, SPREAD, STABLE, plain_float64

torch.set_num_threads(1)

SCENE = "franka/neural_clutter"
B, T = 8, 5


def test_scene_swaps_the_obstacle_leaf_for_the_learned_one(monkeypatch):
    """Every policy but the last is the randomized scene's; the last is the
    learned leaf on the hand leaf's taskmap and ctx key, in its barrier
    variant with the committed weights. RMP_NEURAL_CLUTTER_BARRIER=0 and
    RMP_NEURAL_CLUTTER_ASSET pick the other head and another file."""
    env = envs.make(SCENE, device="cpu")
    hand = envs.make("franka/randomized_cluttered", device="cpu")
    assert [p.name for p in env.policies[:-1]] == [
        p.name for p in hand.policies[:-1]]
    leaf = env.policies[-1]
    assert leaf.name == "neural_obstacle"
    assert leaf.ctx_key == hand.policies[-1].ctx_key
    assert leaf.params["repulsion_boost"] == 40.0
    assert leaf.params["metric_exploder_std_dev"] == np.float32(0.02)
    with np.load(neural_clutter.ASSET) as data:
        for k in data.files:
            np.testing.assert_array_equal(leaf.params["net"][k].numpy(),
                                          data[k])
    assert env.resolve_method == "solve" and env.stuck_fn is not None
    other = neural_clutter.ASSET.replace(".npz", "_unconstrained.npz")
    monkeypatch.setenv("RMP_NEURAL_CLUTTER_BARRIER", "0")
    monkeypatch.setenv("RMP_NEURAL_CLUTTER_ASSET", other)
    plain = envs.make(SCENE, device="cpu").policies[-1]
    assert plain.params["repulsion_boost"] == 0.0
    assert plain.params["metric_exploder_std_dev"] == 1e9
    with np.load(other) as data:
        for k in data.files:
            np.testing.assert_array_equal(plain.params["net"][k].numpy(),
                                          data[k])


def test_train_mode_carries_the_clearances():
    """train=True: no resampling or stuck hooks, and each tick's aux holds
    the per-pair obstacle distances (B, T, L, K) after the tick."""
    env = neural_clutter.make_neural_clutter_env(
        "cpu", gen=torch.Generator().manual_seed(2), train=True)
    assert env.on_solved is None and env.stuck_fn is None
    states = envs.make_batched_reset(env, 3)()
    final, aux = envs.make_batched_rollout(env, 3)(states,
                                                   env.gather_params())
    L, Kc = len(env.model.collision_frames), states.sim.obstacles.count
    assert aux["obst_d"].shape == (3, 3, L, Kc)
    want = robot_obstacle_distances(env.model, K.fk_all(env.model,
                                                        final.sim.q),
                                    final.sim.obstacles)[3]
    assert torch.equal(aux["obst_d"][:, -1], want)
    assert bool(torch.isfinite(final.sim.q).all())


@pytest.fixture(scope="module")
def scene():
    """(JAX env, JAX reset states of B envs, JAX params, port params)."""
    jenv = jenvs.make(SCENE)
    states = jenvs.make_batched_reset(jenv, B)(jax.random.PRNGKey(0))
    params = jenv.gather_params()
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        "cpu")
    return jenv, states, params, tparams


def port_state(state):
    return convert.state_from_numpy(jax_leaves(state), "cpu")


def test_plain_k1_on_a_real_tick_matches_jax(scene):
    """K1 on the port's own blocks of a tick 3 ticks in (strided views as
    the tick makes them; the learned leaf's 80 scalar rows last) against
    JAX's K1 body run eagerly."""
    _, states, _, tparams = scene
    env = envs.make(SCENE, device="cpu")
    state, _ = envs.make_batched_rollout(env, 3, with_aux=False)(
        port_state(states), tparams)
    state = env.pre_tick(state)
    q, qd, prm, ctxs, fk = base._policy_inputs(env, state, tparams)
    tags, tblocks = policy_row_blocks_structured(env.policies, q, qd, prm,
                                                 ctxs, fk=fk)
    layout = tuple((t, b[0].shape[1] if t != "identity" else 0)
                   for t, b in zip(tags, tblocks))
    assert layout == (("dense", 3), ("identity", 0), ("identity", 0),
                      ("identity", 0), ("scalar", 80))
    blocks = [tuple(x.numpy() for x in b) for b in tblocks]
    before = cuda_resolve.pullback_resolve_structured.launches
    got = cuda_resolve.pullback_resolve_structured(tags, tblocks).numpy()
    assert cuda_resolve.pullback_resolve_structured.launches == before
    _assert_k1(got, jax_k1_body(tags, blocks))


def _port_q(start, tparams, float64=False, ulp=False):
    env = envs.make(SCENE, device="cpu")
    state = convert.state_from_numpy(start, "cpu")
    if ulp:
        up = torch.tensor(float("inf"))
        state = dataclasses.replace(state, sim=dataclasses.replace(
            state.sim, q=torch.nextafter(state.sim.q, up),
            qd=torch.nextafter(state.sim.qd, up)))
    if float64:
        state = _to(state, torch.float64)
        tparams = tuple(_to(p, torch.float64) for p in tparams)
    with plain_float64() if float64 else contextlib.nullcontext():
        final, aux = envs.make_batched_rollout(env, T)(state, tparams)
    return final.sim.q.double().numpy(), aux


def test_tick_parity_with_jax(scene):
    """T ticks at B = 8 from JAX's reset against JAX's batched rollout (K1
    and K3 through their plain versions here). Spawns in penetration clamp
    q̈ at max_qdd within the first ticks, where rounding parts runs fast,
    so each env's gap to JAX is held to max(Q_TOL, SPREAD x the larger
    move of the port's float64 and one-ulp runs), as
    tests/test_torch_randomized_parity.py holds the randomized scene's
    hull tier; at least a quarter of the envs move less than STABLE."""
    jenv, states, params, tparams = scene
    jfinal, jaux = jax.jit(jenvs.make_batched_rollout(jenv, T))(states,
                                                                params)
    assert not np.asarray(jaux["resample"]).any()
    start = jax_leaves(states)
    q, aux = _port_q(start, tparams)
    assert not aux["resample"].any()
    move = np.maximum(np.abs(q - _port_q(start, tparams, float64=True)[0]),
                      np.abs(q - _port_q(start, tparams, ulp=True)[0])
                      ).max(axis=1)
    gap = np.abs(q - np.asarray(jfinal.sim.q)).max(axis=1)
    assert (gap <= np.maximum(Q_TOL, SPREAD * move)).all(), (gap, move)
    assert (move <= STABLE).sum() >= B // 4, move


def test_trained_clutter_asset_behaves():
    """tests/test_neural.py's criterion at its size: 32 unseen episodes x
    100 ticks without resampling; the mean final EE-goal distance under
    0.3 m and the share of envs that ever penetrate deeper than 1 cm
    under 0.6."""
    env = dataclasses.replace(envs.make(SCENE, device="cpu"), on_solved=None,
                              stuck_fn=None,
                              aux_fn=neural_clutter.clearance_aux)
    states = envs.make_batched_reset(env, 32, seed=123)()
    final, aux = envs.make_batched_rollout(env, 100)(states,
                                                     env.gather_params())
    d = np.linalg.norm(aux["ee"][:, -1].numpy() - final.sim.goal.numpy(),
                       axis=-1)
    assert np.isfinite(d).all()
    assert d.mean() < 0.3, f"trained clutter policy regressed: {d.mean()}"
    ever_pen = (aux["obst_d"].amin(dim=(-2, -1)).amin(dim=-1)
                < -0.01).double().mean().item()
    assert ever_pen < 0.6, f"collision behavior regressed: {ever_pen}"
