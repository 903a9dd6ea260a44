"""The port's two-joint, UR5 and franka/01 scenes against the JAX package:
5-tick batched parity on the same states, and the random resampling on its
own (the JAX package's random streams are not reproduced, so the parity runs
hold only ticks before the first resample)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu import core as jcore
from rmp_tpu import envs as jenvs
from rmp_tpu.envs import base as jbase
from rmp_tpu.sim import world as jworld
from rmp_tpu_torch import convert, envs
from rmp_tpu_torch.envs.base import ee_position

torch.set_num_threads(1)

B, T = 8, 5
QDD_TOL = 2e-3       # first-tick |Δq̈| <= QDD_TOL * max(1, |q̈|), env by env
Q_TOL = 5e-4         # |Δq| after T ticks
SCENES = ("two_joint/01_target_rmp_only", "two_joint/02_jointspace_biasing",
          "two_joint/03_jointlimit_avoiding",
          "two_joint/04_driving_into_jointlimits",
          "two_joint/05_obstacle_avoidance",
          "two_joint/05_obstacle_avoidance_variant",
          "franka/01_target_rmp_only", "ur5/01_target_reaching",
          "ur5/02_obstacle_avoidance")


def jax_state_leaves(state):
    """A JAX EnvState's leaves in convert.state_from_numpy's layout."""
    obs = state.sim.obstacles
    leaves = dict(q=state.sim.q, qd=state.sim.qd, t=state.sim.t,
                  goal=state.sim.goal, steps=state.steps,
                  solved_count=state.solved_count, phase=state.phase,
                  goal_best=state.goal_best, no_progress=state.no_progress)
    if obs is not None:
        leaves["obstacles"] = dict(p0=obs.p0, p1=obs.p1, radius=obs.radius,
                                   kinds=obs.kinds)
    return leaves


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


def port_inputs(name, states, params):
    env = envs.make(name, device="cpu")
    return (env, convert.state_from_numpy(
        jax.tree.map(np.asarray, jax_state_leaves(states)), "cpu"),
        convert.params_from_numpy(jax.tree.map(np.asarray, params), "cpu"))


def assert_tick_parity(aux, jaux, final, jfinal):
    """The first tick's q̈ env by env, scaled by its size: near its
    straight reset pose the two-joint arm's metric has cond(A) up to ~6e5
    (CPU run), where two float32 pseudo-inverses part by ~2.6e-3 on a q̈ of
    7; then q after T ticks and the bookkeeping."""
    want = np.asarray(jaux["qdd"])[:, 0]
    err = np.abs(aux["qdd"][:, 0].numpy() - want).max(axis=1)
    limit = QDD_TOL * np.maximum(1.0, np.abs(want).max(axis=1))
    assert (err <= limit).all(), f"first-tick q̈: {err} (limits {limit})"
    q_err = np.abs(final.sim.q.numpy() - np.asarray(jfinal.sim.q)).max()
    assert q_err < Q_TOL, f"q after {T} ticks: {q_err}"
    for name in ("steps", "solved_count", "phase"):
        np.testing.assert_array_equal(getattr(final, name).numpy(),
                                      np.asarray(getattr(jfinal, name)))
    np.testing.assert_allclose(final.sim.goal.numpy(),
                               np.asarray(jfinal.sim.goal), atol=0)


@pytest.mark.parametrize("name", SCENES)
def test_scene_tick_parity_with_jax(name):
    """T ticks of the port's batched rollout (CPU, plain kernels) against
    the JAX batched rollout, resampling on: no env reaches its goal in
    these ticks, which the test checks, so no draw is kept."""
    jenv = jenvs.make(name)
    states = perturbed_jax_states(jenv, 7)
    params = jenv.gather_params()
    jfinal, jaux = jax.jit(jenvs.make_batched_rollout(jenv, T))(states,
                                                                 params)
    assert not np.asarray(jaux["solved"]).any()
    env, state, tparams = port_inputs(name, states, params)
    assert env.resolve_method == jenv.resolve_method
    final, aux = envs.make_batched_rollout(env, T)(state, tparams)
    assert not aux["solved"].any()
    assert_tick_parity(aux, jaux, final, jfinal)


def test_franka01_torque_mode_tick_parity():
    """franka/01 with torque_mode on. The JAX reference is built from the
    JAX package's own pieces, each jitted alone (its whole torque-mode tick
    compiles for over a minute on the CPU): the tick's q̈ (_policy_inputs
    and evaluate_policies), then control_every torque-mode physics steps."""
    name = "franka/01_target_rmp_only"
    jenv = jenvs.make(name)
    jenv.torque_mode = True
    states = perturbed_jax_states(jenv, 7)
    params = jenv.gather_params()

    def command(state):
        q, qd, params_b, ctxs, fk = jbase._policy_inputs(jenv, state, params)
        return jcore.evaluate_policies(jenv.policies, q, qd, params_b, ctxs,
                                       method=jenv.resolve_method, fk=fk)
    qdd_fn = jax.jit(jax.vmap(command))
    substep = jax.jit(jax.vmap(lambda sim, a: jworld.physics_step(
        jenv.model, sim, a, jenv.dt, torque_mode=True)))
    env, state, tparams = port_inputs(name, states, params)
    env.torque_mode = True
    final, aux = envs.make_batched_rollout(env, T)(state, tparams)
    assert not aux["solved"].any()

    jstates, qdd0 = states, None
    for _ in range(T):
        qdd = qdd_fn(jstates)
        qdd0 = np.asarray(qdd) if qdd0 is None else qdd0
        sim = jstates.sim
        for _ in range(jenv.control_every):
            sim = substep(sim, qdd)
        jstates = dataclasses.replace(jstates, sim=sim)
    err = np.abs(aux["qdd"][:, 0].numpy() - qdd0).max()
    assert err < QDD_TOL, f"first-tick q̈: {err}"
    q_err = np.abs(final.sim.q.numpy() - np.asarray(jstates.sim.q)).max()
    assert q_err < Q_TOL, f"q after {T} ticks: {q_err}"
    exact, _ = envs.make_batched_rollout(
        dataclasses.replace(env, torque_mode=False), T)(
        port_inputs(name, states, params)[1], tparams)
    assert float((exact.sim.q - final.sim.q).abs().max()) > 0.0


def _solve_half(name, seed):
    """(env, state, params) of B states of scene `name` at rest where envs
    [0, B/2) have reached their goal: the goal moved onto their EE, or, for
    a resample-q scene, q at mid-limits (where the EE goal is) with zero
    velocity."""
    env = envs.make(name, device="cpu")
    state = envs.make_batched_reset(env, B, seed)()
    sim = state.sim
    half = torch.arange(B) < B // 2
    if name == "two_joint/03_jointlimit_avoiding":
        mid = torch.as_tensor(0.5 * (env.model.q_lower + env.model.q_upper))
        sim = dataclasses.replace(sim, q=torch.where(half[:, None], mid,
                                                     sim.q))
    else:
        sim = dataclasses.replace(sim, goal=torch.where(
            half[:, None], ee_position(env, sim), sim.goal))
    return env, dataclasses.replace(state, sim=sim), env.gather_params()


RESAMPLE = {"two_joint/01_target_rmp_only": ("goal", [0.1, 0.1, 0.1],
                                             [1.4, -1.4, 0.1]),
            "franka/01_target_rmp_only": ("goal", [0.3, -0.7, 0.3],
                                          [0.7, 0.7, 0.7]),
            "ur5/01_target_reaching": ("goal", [0.3, -0.5, 0.2],
                                       [0.6, 0.5, 0.6]),
            "two_joint/03_jointlimit_avoiding": ("q", None, None)}


@pytest.mark.parametrize("name", RESAMPLE)
def test_resampling_draws_in_the_box_and_touches_only_solved_envs(name):
    """One tick from states where half the envs have reached their goal:
    those take a fresh draw (a goal in the scene's box, or a configuration
    within the joint limits with q̇ zeroed) and count the goal; the others
    match the same tick without resampling exactly. Draws differ from env
    to env, repeat for the same seed and change with it."""
    field, low, high = RESAMPLE[name]
    env, state, params = _solve_half(name, seed=3)
    step = envs.make_batched_control_step(env)
    out, aux = step(state, params)
    solved = aux["solved"]
    assert solved.tolist() == [True] * (B // 2) + [False] * (B - B // 2)
    np.testing.assert_array_equal(out.solved_count.numpy(),
                                  solved.int().numpy())

    quiet = dataclasses.replace(env, on_solved=None)
    ref, _ = envs.make_batched_control_step(quiet)(
        _solve_half(name, seed=3)[1], params)
    keep = ~solved
    for attr in ("q", "qd", "goal"):
        np.testing.assert_array_equal(getattr(out.sim, attr)[keep].numpy(),
                                      getattr(ref.sim, attr)[keep].numpy())

    new = (out.sim.goal if field == "goal" else out.sim.q)[solved]
    if field == "goal":
        lo = np.minimum(low, high).astype(np.float32)
        hi = np.maximum(low, high).astype(np.float32)
    else:
        lo, hi = env.model.q_lower, env.model.q_upper
        assert not out.sim.qd[solved].any()
    assert ((new.numpy() >= lo) & (new.numpy() <= hi)).all()
    spread = new.numpy().max(axis=0) - new.numpy().min(axis=0)
    assert (spread[np.asarray(hi) > np.asarray(lo)] > 0).all()

    again, _ = envs.make_batched_control_step(env)(
        _solve_half(name, seed=3)[1], params)
    other, _ = envs.make_batched_control_step(env)(
        _solve_half(name, seed=4)[1], params)
    pick = (lambda s: s.sim.goal) if field == "goal" else (lambda s: s.sim.q)
    assert torch.equal(pick(again), pick(out))
    assert not torch.equal(pick(other)[solved], new)


# ------------------------------------------ the seventh slice's scenes ----

SCENES7 = ("franka/03_self_avoidance", "franka/04_nullspace_control",
           "franka/pose_target", "franka/moving_goal",
           "franka/moving_obstacles")


def _jax_rollout(jenv, states, params):
    return jax.jit(jenvs.make_batched_rollout(jenv, T))(states, params)


@pytest.mark.parametrize("name", SCENES7)
def test_seventh_slice_scene_tick_parity_with_jax(name):
    """T ticks of each new scene's batched rollout against the JAX batched
    rollout (per env at B = 8) from the same perturbed states: the
    update_scene scenes move their goal or obstacles on both sides, franka/03
    builds its context by its context_fn, franka/04 starts from its IK pose.
    No env reaches a goal in these ticks. The moved obstacles too."""
    jenv = jenvs.make(name)
    states = perturbed_jax_states(jenv, 7)
    params = jenv.gather_params()
    jfinal, jaux = _jax_rollout(jenv, states, params)
    assert not np.asarray(jaux["solved"]).any()
    env, state, tparams = port_inputs(name, states, params)
    assert env.resolve_method == jenv.resolve_method
    final, aux = envs.make_batched_rollout(env, T)(state, tparams)
    assert not aux["solved"].any()
    assert_tick_parity(aux, jaux, final, jfinal)
    if jfinal.sim.obstacles is not None:
        for field in ("p0", "p1", "radius"):
            np.testing.assert_allclose(
                getattr(final.sim.obstacles, field).numpy(),
                np.asarray(getattr(jfinal.sim.obstacles, field)), atol=1e-6)
        assert final.sim.obstacles.kinds == jfinal.sim.obstacles.kinds


def test_moving_obstacles_hull_tier_tick_parity_with_jax():
    """franka/moving_obstacles with collision_geometry 'hull' at B = 8: the
    per-env semantics in both packages (every pair, cold), the obstacles
    moving under the GJK queries."""
    name = "franka/moving_obstacles"
    jenv = jenvs.make(name)
    jenv.collision_geometry = "hull"
    states = perturbed_jax_states(jenv, 8)
    params = jenv.gather_params()
    jfinal, jaux = _jax_rollout(jenv, states, params)
    env, state, tparams = port_inputs(name, states, params)
    env.collision_geometry = "hull"
    final, aux = envs.make_batched_rollout(env, T)(state, tparams)
    assert final.gjk_warm is None
    assert not aux["solved"].any() and not np.asarray(jaux["solved"]).any()
    assert_tick_parity(aux, jaux, final, jfinal)


def test_self_avoidance_hull_tier_raises():
    """franka/03 in the hull tier raised NotImplementedError until the
    hull-vs-hull query was ported (ROADMAP M12); it now raises nothing, and
    its context_fn gives the self pairs' hull distances
    (collision.robot_self_distances_hull), not the capsule ones. Its parity
    with JAX: tests/test_torch_dual_parity.py."""
    from rmp_tpu_torch.models import kinematics as K
    from rmp_tpu_torch.sim import collision
    env = envs.make("franka/03_self_avoidance", device="cpu")
    env.collision_geometry = "hull"
    state = envs.make_batched_reset(env, 2)()
    T_all = K.fk_all(env.model, state.sim.q)
    ctx = env.context_fn(env.model, state.sim, T_all)
    frames = sorted(ctx)
    pairs = [p for f in frames for p in env_pairs(env) if
             env.model.frame_names[p[0]] == f]
    got = torch.cat([ctx[f]["distance"] for f in frames], dim=1)
    hull = collision.robot_self_distances_hull(env.model, T_all, pairs)[3]
    cap = collision.robot_self_distances(env.model, T_all, pairs)[3]
    assert torch.equal(got, hull) and not torch.equal(got, cap)
    after, _ = envs.make_batched_control_step(env)(state,
                                                   env.gather_params())
    assert bool(torch.isfinite(after.sim.q).all())


def env_pairs(env):
    """franka/03's self pairs, as its constructor picks them."""
    from rmp_tpu_torch.envs.franka import Q_READY
    from rmp_tpu_torch.sim.collision import self_collision_pairs
    return self_collision_pairs(env.model, n_neighbors=3,
                                exclude_below=0.12, q_ref=Q_READY)


@pytest.mark.parametrize("name", ["franka/pose_target", "franka/moving_goal"])
def test_per_env_control_step_matches_jax(name):
    """make_rollout (make_control_step T times: evaluate_policies and
    core.resolve, never K1) against the JAX package's per-env rollout, one
    scene of each resolve method ('pinv', 'solve')."""
    jenv = jenvs.make(name)
    states = perturbed_jax_states(jenv, 9)
    params = jenv.gather_params()
    jfinal, jaux = _jax_rollout(jenv, states, params)
    env, state, tparams = port_inputs(name, states, params)
    final, aux = envs.make_rollout(env, T)(state, tparams)
    assert_tick_parity(aux, jaux, final, jfinal)
    one, _ = envs.make_control_step(env)(
        port_inputs(name, states, params)[1], tparams)
    assert int(one.steps[0]) == 1


def test_moving_goal_scene_lags_one_tick():
    """update_scene runs after the tick's resolve: the goal a rollout of T
    ticks leaves is the circle's point at the last tick's start time,
    (T - 1) control periods, while sim time has run T periods."""
    env = envs.make("franka/moving_goal", device="cpu")
    final, _ = envs.make_batched_rollout(env, T)(
        envs.make_batched_reset(env, 2)(), env.gather_params())
    period = env.dt * env.control_every
    t_last = torch.full((2,), (T - 1) * period)
    wt = 0.4 * t_last
    want = torch.tensor([0.5, 0.0, 0.45]) + 0.15 * torch.stack(
        [torch.zeros(2), torch.cos(wt), torch.sin(wt)], dim=-1)
    np.testing.assert_allclose(final.sim.goal.numpy(), want.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(final.sim.t.numpy(), T * period, atol=1e-5)


def test_per_frame_obstacle_policies_match_grouped_and_jax():
    """_obstacle_policies(grouped=False), one policy per collision frame on
    fk_frame∘frame_to_point_distance, gives the grouped policy's q̈ and the
    JAX package's per-frame q̈ on the flagship's perturbed states."""
    from rmp_tpu.envs import franka as jfranka
    from rmp_tpu_torch.core import evaluate_policies
    from rmp_tpu_torch.envs import franka
    from rmp_tpu_torch.envs.base import _policy_inputs
    name = "franka/06_cluttered_environment"
    jenv = jenvs.make(name)
    states = perturbed_jax_states(jenv, 10)
    params = jenv.gather_params()
    env, state, tparams = port_inputs(name, states, params)
    per_frame = franka._obstacle_policies(env.model, grouped=False)
    assert len(per_frame) == len(env.model.collision_frames)
    ungrouped = env.policies[:-1] + tuple(per_frame)
    env_u = dataclasses.replace(env, policies=ungrouped)
    prm_u = tparams[:-1] + tuple(p.params for p in per_frame)
    outs = {}
    for key, e, prm in (("grouped", env, tparams), ("per_frame", env_u, prm_u)):
        q, qd, prm_b, ctxs, fk = _policy_inputs(e, state, prm)
        outs[key] = evaluate_policies(e.policies, q, qd, prm_b, ctxs,
                                      "solve", fk=fk).numpy()
    np.testing.assert_allclose(outs["per_frame"], outs["grouped"], atol=1e-4)

    jper = jfranka._obstacle_policies(jenv.model, grouped=False)
    jenv_u = dataclasses.replace(jenv, policies=jenv.policies[:-1]
                                 + tuple(jper))
    jprm = jenv_u.gather_params()

    def command(s):
        q, qd, prm_b, ctxs, fk = jbase._policy_inputs(jenv_u, s, jprm)
        return jcore.evaluate_policies(jenv_u.policies, q, qd, prm_b, ctxs,
                                       method="solve", fk=fk)
    want = np.asarray(jax.jit(jax.vmap(command))(states))
    err = np.abs(outs["per_frame"] - want).max(axis=1)
    assert (err <= QDD_TOL * np.maximum(1.0, np.abs(want).max(axis=1))).all()


def test_registry_holds_sixteen_scenes_on_the_card_by_default(monkeypatch):
    """The registry's scenes: the 16 of the seventh slice, the five new
    ones among them, since the eighth franka/randomized_cluttered, since
    the ninth the two dual-arm scenes and since the tenth franka/02 and the
    three learned-policy scenes: all 23 of the JAX package's, under the
    same names. envs.make builds a scene on the GPU unless device='cpu' is
    passed, and raises without one (franka/04's IK runs on the scene's
    device, the learned scenes load their weights onto it)."""
    assert len(envs.REGISTRY) == 23
    assert set(SCENES7) <= set(envs.REGISTRY)
    assert set(envs.REGISTRY) == set(jenvs.REGISTRY)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in SCENES7 + ("franka/randomized_cluttered",
                           "dual_panda/handover",
                           "dual_panda/randomized_clutter",
                           "franka/02_provoke_collision",
                           "two_joint/neural_reach", "franka/neural_reach",
                           "franka/neural_clutter"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            envs.make(name)
