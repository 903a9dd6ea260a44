"""franka/randomized_cluttered in the port against the JAX package: each
piece of the scene (pre_tick, the state-aware bind, on_solved, stuck_fn,
the detour IK, the stuck bookkeeping of _advance) fed the JAX package's
own inputs, then the port's behaviour on its own (the JAX package's
behaviour tests, tests/test_envs.py, mirrored).

jax.random streams are not reproduced: pre_tick is fed the normal draw
JAX makes from each env's key (normal(split(key)[1], (3,))), and a goal
event's new goal is held to its contract, not to JAX's draw."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu import envs as jenvs
from rmp_tpu.envs import base as jbase
from rmp_tpu.models import kinematics as JK
from rmp_tpu_torch import convert, envs
from rmp_tpu_torch.envs import base, franka
from rmp_tpu_torch.envs.base import ee_position
from rmp_tpu_torch.sim.collision import ObstacleSet, cylinder_obstacle

torch.set_num_threads(1)

SCENE = "franka/randomized_cluttered"
B = 16
ATOL = 2e-6          # float32 points, distances and bound gains
Q_TOL = 5e-4         # tests/test_torch_scenes.py's q tolerance
IK_TOL = 1e-4        # the detour IK: 8 DLS steps, closed-form J vs jacfwd


def jax_leaves(state) -> dict:
    """A JAX EnvState as numpy leaves in convert.state_from_numpy's layout,
    scratch included."""
    obs = state.sim.obstacles
    return jax.tree.map(np.asarray, dict(
        q=state.sim.q, qd=state.sim.qd, t=state.sim.t, goal=state.sim.goal,
        steps=state.steps, solved_count=state.solved_count,
        phase=state.phase, goal_best=state.goal_best,
        no_progress=state.no_progress, scratch=state.scratch,
        obstacles=dict(p0=obs.p0, p1=obs.p1, radius=obs.radius,
                       kinds=obs.kinds)))


def port_state(state):
    return convert.state_from_numpy(jax_leaves(state), "cpu")


@pytest.fixture(scope="module")
def scene():
    """(JAX env, port env, JAX reset states of B envs, JAX params, port
    params)."""
    jenv = jenvs.make(SCENE)
    env = envs.make(SCENE, device="cpu")
    states = jenvs.make_batched_reset(jenv, B)(jax.random.PRNGKey(0))
    params = jenv.gather_params()
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        "cpu")
    return jenv, env, states, params, tparams


def _replace(jenv, states, rng, **scratch):
    """JAX states with the bookkeeping and scratch entries mixed per env:
    stall counts on both sides of the triggers, best distances near, far
    and +inf, budgets used and not, detours in flight (arrived and not),
    late phases, ring shifts, and the knobs' other branches."""
    n = states.steps.shape[0]

    def pick(choices, dtype):
        return jnp.asarray(rng.choice(choices, n).astype(dtype))
    ee = jax.vmap(lambda q: JK.fk_frame(jenv.model, q, jenv.ee_frame)[:3, 3])(
        states.sim.q)
    sc = dict(states.scratch)
    near = jnp.asarray(rng.random(n) < 0.5)[:, None]
    sc.update(man_ticks=pick([0, 0, 5], np.int32),
              man_count=pick([0, 1, 2], np.int32),
              push_on=pick([False, True], bool),
              wp=jnp.where(near, ee + 0.01, ee + jnp.asarray([0.0, 0.3,
                                                              0.0])))
    cfg = dict(sc["cfg"])
    cfg.update(esc_cand=pick([1.0, 1.0, 0.0], np.float32),
               esc_qspace=pick([0.0, 1.0, 2.0], np.float32),
               push_latch=pick([0.0, 1.0], np.float32),
               esc_axis1=pick([0.0, 1.0], np.float32),
               man_budget_late=pick([0.0, 1.0], np.float32),
               push_relax_metric=pick([0.0, 1.0], np.float32))
    sc["cfg"] = cfg
    no_progress = pick([0, 19, 20, 39, 40, 45, 80], np.int32)
    goal_best = pick([0.05, 0.3, np.inf], np.float32)
    phase = pick([0, 0, 7], np.int32)
    # envs 0-3 at a trigger (no detour in flight, budget left), 4-5 at a
    # near-goal stall
    trig = jnp.arange(n) < 4
    sc["man_ticks"] = jnp.where(trig, 0, sc["man_ticks"])
    sc["man_count"] = jnp.where(trig, 0, sc["man_count"])
    no_progress = jnp.where(trig, 40, no_progress)
    phase = jnp.where(trig, 0, phase)
    stall = (jnp.arange(n) >= 4) & (jnp.arange(n) < 6)
    no_progress = jnp.where(stall, 20, no_progress)
    goal_best = jnp.where(stall, 0.05, goal_best)
    sc.update(scratch)
    return dataclasses.replace(
        states, scratch=sc, no_progress=no_progress, goal_best=goal_best,
        phase=phase, steps=pick([0, 3, 8, 16], np.int32))


def _jax_normals(keys):
    return jax.vmap(lambda k: jax.random.normal(jax.random.split(k)[1],
                                                (3,)))(keys)


def _port_pre_tick(env, state, v, monkeypatch):
    """env.pre_tick with its normal draw replaced by v (B, 3)."""
    v = torch.tensor(np.asarray(v))
    with monkeypatch.context() as m:
        m.setattr(torch, "randn", lambda *a, **k: v)
        return env.pre_tick(state)


def test_pre_tick_matches_jax(scene, monkeypatch):
    """pre_tick on mixed states, fed JAX's normal draws: triggers, timers,
    counts, the push latch and the ring exactly; the waypoint and the
    progress window to float32 rounding; the detour IK to IK_TOL."""
    jenv, env, states, _, _ = scene
    rng = np.random.default_rng(0)
    mixed = _replace(jenv, states, rng)
    want = jax.jit(jax.vmap(jenv.pre_tick))(mixed)
    got = _port_pre_tick(env, port_state(mixed),
                         _jax_normals(mixed.key), monkeypatch)
    triggered = np.asarray(want.scratch["man_count"]
                           > mixed.scratch["man_count"])
    assert 2 <= triggered.sum() < B
    for k in ("man_ticks", "man_count", "push_on", "q_hist"):
        np.testing.assert_array_equal(got.scratch[k].numpy(),
                                      np.asarray(want.scratch[k]), err_msg=k)
    np.testing.assert_array_equal(got.no_progress.numpy(),
                                  np.asarray(want.no_progress))
    np.testing.assert_array_equal(got.goal_best.numpy(),
                                  np.asarray(want.goal_best))
    np.testing.assert_allclose(got.scratch["wp"].numpy(),
                               np.asarray(want.scratch["wp"]), atol=ATOL)
    np.testing.assert_allclose(got.scratch["q_wp"].numpy(),
                               np.asarray(want.scratch["q_wp"]),
                               atol=IK_TOL)
    # the sim and the knobs pass through untouched
    assert torch.equal(got.sim.q, port_state(mixed).sim.q)


def test_detour_ik_matches_jax(scene):
    """franka.ik_toward (K3's closed-form Jacobian, its plain version on
    the CPU) against the JAX package's DLS steps with jax.jacfwd, from the
    reset poses toward random points 10-30 cm away."""
    jenv, env, states, _, _ = scene
    rng = np.random.default_rng(1)
    q = np.asarray(states.sim.q)
    ee = ee_position(env, port_state(states).sim).numpy()
    step = rng.normal(size=(B, 3))
    target = (ee + rng.uniform(0.1, 0.3, (B, 1)) * step
              / np.linalg.norm(step, axis=1, keepdims=True)).astype(np.float32)
    model, ee_idx = jenv.model, jenv.ee_frame

    def jax_ik(qq, tgt):
        def err(x):
            return tgt - JK.fk_frame(model, x, ee_idx)[:3, 3]

        def body(_, x):
            e = err(x)
            J = jax.jacfwd(err)(x)
            A = J @ J.T + 1e-4 * jnp.eye(3, dtype=jnp.float32)
            x = x - 0.5 * (J.T @ jnp.linalg.solve(A, e))
            return jnp.clip(x, jnp.asarray(model.q_lower),
                            jnp.asarray(model.q_upper))
        return jax.lax.fori_loop(0, franka.IK_STEPS, body, qq)
    want = np.asarray(jax.jit(jax.vmap(jax_ik))(jnp.asarray(q),
                                                jnp.asarray(target)))
    got = franka.ik_toward(env.model, torch.tensor(q), torch.tensor(target))
    np.testing.assert_allclose(got.numpy(), want, atol=IK_TOL)
    moved = torch.linalg.vector_norm(
        ee_position(env, dataclasses.replace(port_state(states).sim, q=got))
        - torch.tensor(target), dim=-1)
    assert float(moved.max()) < 0.02


@pytest.mark.parametrize("case", ["neither", "escaping", "push", "mixed"])
def test_bind_matches_jax(scene, case):
    """The state-aware bind on states with no detour and no push, a detour
    in flight (the attractor chases the waypoint, the obstacle metric
    relaxes, with esc_qspace the c-space goal moves), the push engaged
    (gains up, obstacle policy relaxed, metric-only where asked), and a
    per-env mix: every bound entry equals JAX's per env."""
    jenv, env, states, params, tparams = scene
    rng = np.random.default_rng(2)
    mixed = _replace(jenv, states, rng)
    fixed = dict(neither=dict(man_ticks=0, push_on=False),
                 escaping=dict(man_ticks=5, push_on=False),
                 push=dict(man_ticks=0, push_on=True), mixed={})[case]
    mixed = dataclasses.replace(mixed, scratch=dict(
        mixed.scratch, **{k: jnp.full(B, v, mixed.scratch[k].dtype)
                          for k, v in fixed.items()},
        q_wp=mixed.sim.q + 0.1))
    want = jax.vmap(lambda s: jenv.bind_params(params, s.sim, jenv.policies,
                                               s))(mixed)
    tstate = port_state(mixed)
    got = base.call_bind(env.bind_params, tparams, tstate.sim, env.policies,
                         tstate)
    checked = 0
    for p, g, w in zip(env.policies, got, want):
        for k, wv in w.items():
            gv = g[k]
            gv = (gv.numpy() if isinstance(gv, torch.Tensor)
                  else np.asarray(gv))
            np.testing.assert_allclose(
                np.broadcast_to(gv, np.asarray(wv).shape), np.asarray(wv),
                rtol=1e-6, atol=ATOL, err_msg=f"{p.name}.{k}")
            checked += 1
    assert checked >= 20
    att = [p.name for p in env.policies].index("attractor")
    assert got[att]["accel_p_gain"].shape == (B,)


def test_on_solved_and_stuck_fn_match_jax(scene):
    """on_solved's deterministic part (the detour budget reset, the push
    released, phase set to steps; the new goal 5 cm clear of the env's
    own obstacles) and stuck_fn (the stall window of spent_timeout) on
    mixed states, against JAX's."""
    jenv, env, states, _, _ = scene
    rng = np.random.default_rng(3)
    mixed = _replace(jenv, states, rng)
    # stalls either side of the full (80) and the spent-budget (50) window
    mixed = dataclasses.replace(mixed, no_progress=jnp.asarray(
        rng.choice([10, 49, 50, 79, 80], B), jnp.int32))
    want = jax.vmap(jenv.on_solved)(mixed)
    got = env.on_solved(port_state(mixed))
    for k in ("man_ticks", "man_count", "push_on", "q_hist", "wp", "q_wp"):
        np.testing.assert_array_equal(got.scratch[k].numpy(),
                                      np.asarray(want.scratch[k]), err_msg=k)
    np.testing.assert_array_equal(got.phase.numpy(), np.asarray(want.phase))
    obs = got.sim.obstacles
    goal = got.sim.goal
    from rmp_tpu_torch.sim.collision import capsule_capsule_query
    _, _, _, d = capsule_capsule_query(goal[:, None], goal[:, None],
                                       torch.zeros(1), obs.p0, obs.p1,
                                       obs.radius)
    assert float(d.amin(dim=1).min()) >= 0.05
    assert not torch.equal(goal, port_state(mixed).sim.goal)
    np.testing.assert_array_equal(
        env.stuck_fn(port_state(mixed)).numpy(),
        np.asarray(jax.vmap(jenv.stuck_fn)(mixed)))
    stuck = env.stuck_fn(port_state(mixed))
    assert stuck.any() and not stuck.all()


def test_advance_bookkeeping_matches_jax(scene):
    """_advance with the stuck predicate: at rest with q̈ = 0, envs whose
    goal sits on the EE are solved, envs stalled one tick short of their
    window go stuck, and both take on_solved; the progress window, the
    counts, the phase, the scratch and aux['resample'] equal JAX's, the
    goal is kept where nothing fired."""
    jenv, env, states, _, _ = scene
    rng = np.random.default_rng(4)
    ee = jax.vmap(lambda q: JK.fk_frame(jenv.model, q,
                                        jenv.ee_frame)[:3, 3])(states.sim.q)
    at_goal = jnp.asarray(np.arange(B) % 4 == 0)
    sim = dataclasses.replace(
        states.sim, qd=jnp.zeros_like(states.sim.qd),
        goal=jnp.where(at_goal[:, None], ee, states.sim.goal))
    mixed = dataclasses.replace(_replace(jenv, states, rng), sim=sim)
    mixed = dataclasses.replace(
        mixed, no_progress=jnp.asarray(rng.choice([0, 49, 79, 10], B),
                                       jnp.int32))
    qdd = jnp.zeros_like(sim.q)
    want, jaux = jax.jit(jax.vmap(lambda s, a: jbase._advance(jenv, s, a)))(
        mixed, qdd)
    got, aux = base._advance(env, port_state(mixed), torch.zeros(B, 9))
    event = np.asarray(jaux["resample"])
    np.testing.assert_array_equal(aux["resample"].numpy(), event)
    np.testing.assert_array_equal(aux["solved"].numpy(),
                                  np.asarray(jaux["solved"]))
    solved = np.asarray(jaux["solved"])
    assert solved.any() and (event & ~solved).any() and (~event).any()
    for name in ("steps", "solved_count", "phase", "no_progress"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.goal_best.numpy(),
                               np.asarray(want.goal_best), atol=ATOL)
    for k in ("man_ticks", "man_count", "push_on", "q_hist", "q_wp"):
        np.testing.assert_array_equal(got.scratch[k].numpy(),
                                      np.asarray(want.scratch[k]), err_msg=k)
    np.testing.assert_array_equal(got.sim.goal.numpy()[~event],
                                  np.asarray(want.sim.goal)[~event])
    assert not np.isclose(got.sim.goal.numpy()[event],
                          np.asarray(mixed.sim.goal)[event]).all(1).any()


def test_stuck_fn_needs_on_solved(scene):
    env = scene[1]
    quiet = dataclasses.replace(env, on_solved=None)
    state = envs.make_batched_reset(env, 2)()
    with pytest.raises(ValueError, match="stuck_fn requires on_solved"):
        base._advance(quiet, state, torch.zeros(2, 9))


# ------------------------------------ the port's behaviour on its own ----

def _stalled(env, n: int, delta: int = 0, seed: int = 0):
    """n reset states stalled at the scene's esc_trigger (+ delta) ticks,
    best distance 0.3 m."""
    state = envs.make_batched_reset(env, n, seed)()
    trig = int(state.scratch["cfg"]["esc_trigger"][0])
    return dataclasses.replace(
        state, no_progress=torch.full((n,), trig + delta, dtype=torch.int32),
        goal_best=torch.full((n,), 0.3))


def _with(state, **scratch):
    return dataclasses.replace(state, scratch=dict(state.scratch, **scratch))


def _with_cfg(state, **knobs):
    cfg = dict(state.scratch["cfg"])
    cfg.update({k: torch.full_like(cfg[k], v) for k, v in knobs.items()})
    return _with(state, cfg=cfg)


def test_escape_trigger_spends_budget_and_binds_the_detour(scene):
    """tests/test_envs.py:652 on the port: the detour fires exactly at
    esc_trigger (first goal only, budget permitting), spends one of the
    budget and restarts the progress window; bind points the attractor at
    the waypoint while sim.goal stays; a tick earlier, a spent budget, a
    zero budget or a late phase fire nothing, a late budget fires."""
    env, tparams = scene[1], scene[4]
    s = _stalled(env, 4)
    out = env.pre_tick(s)
    assert (out.scratch["man_ticks"] == 22).all()
    assert (out.scratch["man_count"] == 1).all()
    assert (out.no_progress == 0).all() and torch.isinf(out.goal_best).all()
    wp = out.scratch["wp"]
    assert ((wp >= torch.tensor([-0.85, -0.85, 0.15]))
            & (wp <= torch.tensor([0.85, 0.85, 0.95]))).all()
    i_att = [p.name for p in env.policies].index("attractor")
    bound = base.call_bind(env.bind_params, tparams, out.sim, env.policies,
                           out)
    assert torch.equal(bound[i_att]["goal"], wp)
    assert torch.equal(out.sim.goal, s.sim.goal)
    bound0 = base.call_bind(env.bind_params, tparams, s.sim, env.policies, s)
    assert torch.equal(bound0[i_att]["goal"], s.sim.goal)

    assert not env.pre_tick(_stalled(env, 4, -1)).scratch["man_ticks"].any()
    spent = _with(_stalled(env, 4),
                  man_count=torch.full((4,), 2, dtype=torch.int32))
    out = env.pre_tick(spent)
    assert not out.scratch["man_ticks"].any()
    assert (out.scratch["man_count"] == 2).all()
    assert not env.pre_tick(_with_cfg(_stalled(env, 4), man_budget=0.0)
                            ).scratch["man_ticks"].any()
    late = dataclasses.replace(_stalled(env, 4),
                               phase=torch.full((4,), 7, dtype=torch.int32))
    assert not env.pre_tick(late).scratch["man_ticks"].any()
    late1 = _with_cfg(late, man_budget_late=1.0)
    assert (env.pre_tick(late1).scratch["man_ticks"] > 0).all()
    assert not env.pre_tick(_with(
        late1, man_count=torch.ones(4, dtype=torch.int32))
    ).scratch["man_ticks"].any()


def test_escape_ends_on_arrival(scene):
    """tests/test_envs.py:712: a detour within 6 cm of its waypoint ends;
    with man_arrive 0 it counts down; a far waypoint counts down."""
    env = scene[1]
    state = envs.make_batched_reset(env, 2)()
    ee = ee_position(env, state.sim)
    mid = _with(state, man_ticks=torch.full((2,), 10, dtype=torch.int32),
                wp=ee + 0.01)
    assert not env.pre_tick(mid).scratch["man_ticks"].any()
    assert (env.pre_tick(_with_cfg(mid, man_arrive=0.0))
            .scratch["man_ticks"] == 9).all()
    far = _with(mid, wp=ee + torch.tensor([0.0, 0.3, 0.0]))
    assert (env.pre_tick(far).scratch["man_ticks"] == 9).all()


def test_push_engages_at_a_near_stall_and_relaxes_obstacles(scene):
    """tests/test_envs.py:730: at push_trigger stalled ticks within
    push_near the push engages; bind scales the attractor's gains (d by
    the square root) and divides the obstacle policy's repulsion and
    metric by push_relax; a far or fresh stall does not push; obs_margin
    is added to the margin in every binding."""
    env, tparams = scene[1], scene[4]
    names = [p.name for p in env.policies]
    i_att, i_obs = names.index("attractor"), names.index("collision_avoidance")
    near = dataclasses.replace(envs.make_batched_reset(env, 2)(),
                               no_progress=torch.full((2,), 20,
                                                      dtype=torch.int32),
                               goal_best=torch.full((2,), 0.05))
    out = env.pre_tick(near)
    assert out.scratch["push_on"].all()
    b = base.call_bind(env.bind_params, tparams, out.sim, env.policies, out)
    p_att, p_obs = tparams[i_att], tparams[i_obs]
    np.testing.assert_allclose(b[i_att]["accel_p_gain"].numpy(),
                               p_att["accel_p_gain"] * 3.0)
    np.testing.assert_allclose(b[i_att]["accel_d_gain"].numpy(),
                               p_att["accel_d_gain"] * np.sqrt(3.0),
                               rtol=1e-6)
    np.testing.assert_allclose(b[i_obs]["repulsion_gain"].numpy(),
                               p_obs["repulsion_gain"] / 4.0)
    np.testing.assert_allclose(b[i_obs]["metric_scalar"].numpy(),
                               p_obs["metric_scalar"] / 4.0)
    np.testing.assert_allclose(b[i_obs]["margin"].numpy(),
                               p_obs["margin"] + 0.005, rtol=1e-6)
    far = dataclasses.replace(near, goal_best=torch.full((2,), 0.5))
    assert not env.pre_tick(far).scratch["push_on"].any()
    fresh = dataclasses.replace(near, no_progress=torch.full(
        (2,), 3, dtype=torch.int32))
    assert not env.pre_tick(fresh).scratch["push_on"].any()
    b0 = base.call_bind(env.bind_params, tparams, near.sim, env.policies,
                        env.pre_tick(far))
    np.testing.assert_allclose(b0[i_obs]["repulsion_gain"].numpy(),
                               p_obs["repulsion_gain"])


def test_goal_event_resets_the_escape_budget(scene):
    """tests/test_envs.py:849: on_solved gives a fresh goal, a fresh
    budget, no detour in flight and no push."""
    env = scene[1]
    state = _with(envs.make_batched_reset(env, 3)(),
                  man_ticks=torch.full((3,), 7, dtype=torch.int32),
                  man_count=torch.full((3,), 2, dtype=torch.int32),
                  push_on=torch.ones(3, dtype=torch.bool))
    out = env.on_solved(state)
    assert not out.scratch["man_ticks"].any()
    assert not out.scratch["man_count"].any()
    assert not out.scratch["push_on"].any()
    assert not torch.isclose(out.sim.goal, state.sim.goal).all(1).any()


def test_escape_rescues_a_walled_scene():
    """tests/test_envs.py:893: a wall of three cylinders between the EE and
    the goal traps the reactive policies; with goal timeouts off, only the
    detour (man_budget 3, esc_trigger 35) gets the arm around it, while
    man_budget 0 stays walled off. Per-env semantics (make_rollout), 400
    ticks, both envs in one batch."""
    env = franka.env_randomized_cluttered("cpu", 3)
    wall = ObstacleSet.of(*[cylinder_obstacle([x, 0.20, 0.5], [0, 0, 0],
                                              0.03, 0.7)
                            for x in (0.42, 0.48, 0.54)])
    s = envs.make_batched_reset(env, 2)()
    sim = dataclasses.replace(
        s.sim, q=torch.as_tensor(franka.Q_READY, dtype=torch.float32)
        .expand(2, 9).clone(), qd=torch.zeros(2, 9),
        obstacles=wall.expand(2),
        goal=torch.tensor([[0.48, 0.40, 0.41]]).expand(2, 3).clone())
    s = _with_cfg(dataclasses.replace(s, sim=sim), timeout=1e6,
                  timeout_spent=1e6, esc_trigger=35.0)
    s.scratch["cfg"]["man_budget"] = torch.tensor([0.0, 3.0])
    s = _with(s, q_wp=sim.q.clone(), q_hist=sim.q[:, None].repeat(1, 4, 1))
    final, aux = envs.make_rollout(env, 400)(s, env.gather_params())
    solved = aux["solved"].any(dim=1)
    best = final.goal_best
    assert not solved[0] and best[0] > 0.15, float(best[0])
    assert solved[1], float(best[1])



# ------------------------------------------------ per-env scalar params ----

def _leaf_inputs(rng, n, P, d):
    x = torch.tensor(rng.normal(size=(n, P, d)), dtype=torch.float32)
    xd = torch.tensor(rng.normal(size=(n, P, d)), dtype=torch.float32)
    return x, xd


def _one_env(prm, gains, i):
    """Env i's params: its float of each per-env gain, its row of a per-env
    goal (as a shared (d,) goal)."""
    out = dict(prm, **{k: float(prm[k][i]) for k in gains})
    if "goal" in prm:
        out["goal"] = prm["goal"][i]
    return out


@pytest.mark.parametrize("leaf", ["attractor", "collision_avoidance",
                                  "cspace_target"])
def test_per_env_gains_equal_one_env_calls(leaf):
    """Each v2 leaf the scene binds per env, given (B,) tensors for those
    params (and a (B, d) goal), equals B one-env calls with that env's
    float params, at B = 3 so that a gain broadcast against the last axis
    (d = 3 for the attractor) would show."""
    from rmp_tpu_torch.envs.franka import (_obstacle_policies,
                                           _v2_policy_stack)
    from rmp_tpu_torch.models import robots
    model = robots.franka_panda()
    pols = {p.name: p for p in
            _v2_policy_stack(model, [0.5, 0.0, 0.5], 2.5, 1.5, True, "cpu")
            + _obstacle_policies(model)}
    pol = pols[leaf]
    rng = np.random.default_rng(6)
    n = 3
    gains = dict(
        attractor=("accel_p_gain", "accel_d_gain", "max_metric_scalar",
                   "min_metric_scalar"),
        collision_avoidance=("repulsion_gain", "metric_scalar", "margin"),
        cspace_target=("metric_scalar", "position_gain"))[leaf]
    prm = dict(pol.params)
    for k in gains:
        prm[k] = torch.tensor(rng.uniform(0.5, 2.0, n) * (prm[k] or 0.01),
                              dtype=torch.float32)
    P, d = dict(attractor=(1, 3), collision_avoidance=(5, 1),
                cspace_target=(1, 9))[leaf]
    if "goal" in prm:
        prm["goal"] = torch.tensor(rng.normal(size=(n, d)),
                                   dtype=torch.float32)
    x, xd = _leaf_inputs(rng, n, P, d)
    if leaf == "collision_avoidance":
        x = x.abs() * 0.05
    ctx = None
    a, M = pol.accel_metric(prm, x, xd, ctx)
    for i in range(n):
        a_i, M_i = pol.accel_metric(_one_env(prm, gains, i), x[i:i + 1],
                                    xd[i:i + 1], ctx)
        np.testing.assert_allclose(a[i:i + 1].numpy(), a_i.numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(M[i:i + 1].numpy(), M_i.numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_velocity_cap_takes_float_params_only():
    """The velocity cap's gains are never bound per env; a tensor there
    raises instead of reaching its float32 rounding of the scalars."""
    from rmp_tpu_torch.policies import v2
    pol = v2.joint_velocity_cap(0.8, 0.15, 5.0, 0.05)
    x = torch.zeros(3, 1, 9)
    pol.accel_metric(pol.params, x, x, None)
    prm = dict(pol.params, damping_gain=torch.full((3,), 5.0))
    with pytest.raises(TypeError, match="damping_gain"):
        pol.accel_metric(prm, x, x, None)
