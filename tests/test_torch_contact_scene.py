"""Contact on the physics step and franka/02_provoke_collision against the
JAX package: `physics_step` with either contact model and with
enforce_limits off, 5 ticks of franka/02 at B = 8 from states where the arm
pierces the cylinder, and tests/test_contact.py's ghost-vs-contact
criterion at B = 1 (K3's plain version on the CPU)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu import core as jcore
from rmp_tpu import envs as jenvs
from rmp_tpu.envs import base as jbase
from rmp_tpu.models import robots as jrobots
from rmp_tpu.sim import world as jworld
from rmp_tpu_torch import convert, envs
from rmp_tpu_torch.envs import franka
from rmp_tpu_torch.models import kinematics as K
from rmp_tpu_torch.models import robots
from rmp_tpu_torch.ops import cuda_fk
from rmp_tpu_torch.sim import world
from rmp_tpu_torch.sim.collision import robot_obstacle_distances
from test_torch_scenes import jax_state_leaves

torch.set_num_threads(1)

SCENE = "franka/02_provoke_collision"
B, T = 8, 5
DT = 0.01


def min_clearance(env, q):
    """The least capsule distance (B,) of the arm to the scene's cylinder."""
    obs = env.reset(q.shape[0]).sim.obstacles
    return robot_obstacle_distances(env.model, K.fk_all(env.model, q),
                                    obs)[3].amin(dim=(1, 2))


@pytest.fixture(scope="module")
def piercing():
    """(JAX env, its EnvState of B envs): the contact-free ghost of
    franka/02 (the port's, B = 1) 29 ticks in, where it pierces the
    cylinder by ~2.5 cm, copied B times and moved by q ± 0.02,
    q̇ ± 0.05."""
    ghost = franka.env_02_provoke_collision("cpu", contact=False)
    state = envs.make_batched_reset(ghost, 1)()
    step = envs.make_control_step(ghost)
    for _ in range(29):
        state, _ = step(state, ghost.gather_params())
    assert float(min_clearance(ghost, state.sim.q)) < -0.01
    jenv = jenvs.make(SCENE)
    states = jenvs.make_batched_reset(jenv, B)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    q = state.sim.q.numpy() + rng.uniform(-0.02, 0.02, (B, 9))
    qd = state.sim.qd.numpy() + rng.uniform(-0.05, 0.05, (B, 9))
    return jenv, dataclasses.replace(states, sim=dataclasses.replace(
        states.sim, q=jnp.asarray(q, jnp.float32),
        qd=jnp.asarray(qd, jnp.float32)))


@functools.lru_cache(maxsize=None)
def jax_substep(contact_model: str):
    """JAX's contact physics_step at DT, vmapped and jitted once per
    model."""
    model = jrobots.franka_panda()
    return jax.jit(jax.vmap(lambda sim, a: jworld.physics_step(
        model, sim, a, DT, contact=True, contact_model=contact_model)))


def port_state(jstates):
    return convert.state_from_numpy(
        jax.tree.map(np.asarray, jax_state_leaves(jstates)), "cpu")


@pytest.mark.parametrize("contact_model", ["penalty", "impulse"])
def test_physics_step_with_contact_matches_jax(piercing, contact_model):
    """One contact physics_step (q̈ 0, the torque route, limits enforced)
    from the piercing states: q̇ against JAX's at rtol/atol 1e-5 with
    penalty forces, 1e-4 with impulses (λ's Gauss-Seidel sweeps carry the
    rounding of earlier rows); q at 1e-5. Contact changes q̇ (against the
    torque route without it)."""
    _, jstates = piercing
    model = robots.franka_panda()
    state = port_state(jstates).sim
    zero = torch.zeros(B, 9)
    out = world.physics_step(model, state, zero, DT, contact=True,
                             contact_model=contact_model)
    want = jax_substep(contact_model)(jstates.sim, jnp.zeros((B, 9)))
    tol = 1e-5 if contact_model == "penalty" else 1e-4
    np.testing.assert_allclose(out.qd.numpy(), np.asarray(want.qd),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(out.q.numpy(), np.asarray(want.q),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.t.numpy(), np.asarray(want.t))
    free = world.physics_step(model, state, zero, DT, torque_mode=True)
    assert float((free.qd - out.qd).abs().max()) > 1e-3


def test_physics_step_enforce_limits_matches_jax():
    """enforce_limits=False leaves q past its limits and q̇ outward there,
    as in the JAX package; True clamps q and zeroes that q̇."""
    model, jmodel = robots.two_joint_robot(), jrobots.two_joint_robot()
    q = np.array([[3.1, -3.1]], np.float32)
    qd = np.array([[5.0, -5.0]], np.float32)
    for enforce in (True, False):
        state = world.SimState(q=torch.tensor(q), qd=torch.tensor(qd),
                               t=torch.zeros(1))
        out = world.physics_step(model, state, torch.zeros(1, 2), 0.05,
                                 enforce_limits=enforce)
        js = jworld.physics_step(jmodel, jworld.init_state(jmodel, q=q[0],
                                                           qd=qd[0]),
                                 jnp.zeros(2), 0.05, enforce_limits=enforce)
        np.testing.assert_allclose(out.q[0].numpy(), np.asarray(js.q),
                                   atol=1e-6)
        np.testing.assert_allclose(out.qd[0].numpy(), np.asarray(js.qd),
                                   atol=1e-6)
        assert bool((out.qd == 0).all()) == enforce


def test_provoke_collision_tick_parity_with_jax(piercing):
    """T ticks of franka/02 ('pinv', max_qdd 200, contact in each of the
    10 substeps) from the piercing states against the JAX package's pieces,
    each jitted alone (its whole contact tick compiles for minutes on the
    CPU): the tick's q̈ (_policy_inputs and evaluate_policies, clamped as
    _advance clamps it), then 10 contact physics steps. The first tick's
    q̈ env by env (2e-3 of its size), q after T ticks within 5e-4."""
    jenv, jstates = piercing
    params = jenv.gather_params()

    def command(state):
        q, qd, params_b, ctxs, fk = jbase._policy_inputs(jenv, state, params)
        return jcore.evaluate_policies(jenv.policies, q, qd, params_b, ctxs,
                                       method=jenv.resolve_method, fk=fk)
    qdd_fn = jax.jit(jax.vmap(command))
    substep = jax_substep("penalty")
    env = envs.make(SCENE, device="cpu")
    assert env.contact and env.resolve_method == jenv.resolve_method == "pinv"
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        "cpu")
    before = cuda_fk.fk_derivatives_batched.launches
    final, aux = envs.make_batched_rollout(env, T)(port_state(jstates),
                                                   tparams)
    assert cuda_fk.fk_derivatives_batched.launches == before  # plain on CPU
    assert not aux["solved"].any()

    sim, qdd0 = jstates.sim, None
    for _ in range(T):
        qdd = qdd_fn(dataclasses.replace(jstates, sim=sim))
        qdd = jnp.clip(jnp.nan_to_num(qdd, nan=0.0, posinf=0.0, neginf=0.0),
                       -jenv.max_qdd, jenv.max_qdd)
        qdd0 = np.asarray(qdd) if qdd0 is None else qdd0
        for _ in range(jenv.control_every):
            sim = substep(sim, qdd)
    want = qdd0
    err = np.abs(aux["qdd"][:, 0].numpy() - want).max(axis=1)
    assert (err <= 2e-3 * np.maximum(1.0, np.abs(want).max(axis=1))).all(), \
        err
    q_err = np.abs(final.sim.q.numpy() - np.asarray(sim.q)).max()
    assert q_err < 5e-4, f"q after {T} ticks: {q_err}"
    ghost, _ = envs.make_batched_rollout(
        dataclasses.replace(env, contact=False), T)(port_state(jstates),
                                                    tparams)
    assert float((ghost.sim.q - final.sim.q).abs().max()) > 1e-3


def test_provoke_collision_is_blocked_by_contact():
    """tests/test_contact.py's criterion at B = 1 over 120 ticks (the
    per-env control step): without contact the arm's least distance to the
    cylinder goes below -0.004; with it, it stays at least 0.002 above the
    ghost's, and q stays finite."""
    def run(contact):
        env = franka.env_02_provoke_collision("cpu", contact=contact)
        state = envs.make_batched_reset(env, 1)()
        step = envs.make_control_step(env)
        least = np.inf
        for _ in range(120):
            state, _ = step(state, env.gather_params())
            least = min(least, float(min_clearance(env, state.sim.q)))
        return least, state

    d_ghost, _ = run(False)
    d_contact, s_contact = run(True)
    assert d_ghost < -0.004, f"ghost path should penetrate, got {d_ghost}"
    assert d_contact > d_ghost + 0.002, (d_contact, d_ghost)
    assert bool(torch.isfinite(s_contact.sim.q).all())
